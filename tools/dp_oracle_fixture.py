#!/usr/bin/env python3
"""Writes ``tests/data/dp_oracle.npz``: the reference planner's DP
(tests/dp_oracle.py, the numpy transcription of dp_planner.cpp:39-320) on
the scenarios that tests/test_torch_dp_oracle.py holds the port's
exact-mode DP against, from the start (0, 0, 0). The oracle takes ~50 s a
scenario on a CPU, so its results are kept: per seed the winning cells,
min_cost, ok and the 81-knot coarse trajectory's fields. The scenarios
come from the port's generator (bit-identical to the JAX package's).

Run from the repository root (CPU, no GPU needed):
  python3 tools/dp_oracle_fixture.py
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 2)
FIELDS = ("s", "x", "y", "theta", "velocity", "a", "kappa", "delta")
OUT = os.path.join(HERE, "tests", "data", "dp_oracle.npz")


def main():
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import dp_oracle
    from cilqr_tpu_torch import scenario
    from cilqr_tpu_torch.config import PlannerConfig

    cfg = PlannerConfig()
    out = {"seeds": np.asarray(SEEDS)}
    for seed in SEEDS:
        scn = scenario.make_scenario(seed, dtype=torch.float64, device="cpu")
        want = dp_oracle.DpOracle(dp_oracle.env_from_scenario(scn),
                                  cfg).plan(0.0, 0.0, 0.0)
        out[f"{seed}/sel_cells"] = np.asarray(want["sel_cells"])
        out[f"{seed}/min_cost"] = np.asarray(want["min_cost"])
        out[f"{seed}/ok"] = np.asarray(want["ok"])
        for f in FIELDS:
            out[f"{seed}/{f}"] = np.asarray(want[f], np.float64)
        print(f"seed {seed}: cells {want['sel_cells']}, min_cost "
              f"{want['min_cost']!r}", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {os.path.relpath(OUT, HERE)}")


if __name__ == "__main__":
    main()
