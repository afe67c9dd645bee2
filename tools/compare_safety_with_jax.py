"""The replan's safety counters, the PyTorch port against the JAX package,
on the CPU in float32: near-term (25 knots) dirty lanes before the repair
ladder, repaired lanes, lanes still dirty.

Each side runs its own plan_batch (PlannerConfig(), backend "blast", the
analytic RoadSpec, start (0, 0, 0, 10), unperturbed) on scenarios
``--seeds`` in chunks of 64, as tests/test_pipeline_f32_gate.py's gate F
runs the JAX package. Prints each chunk's counters of both sides, the
lanes dirty before repair on each side, and one JSON line.

    JAX_PLATFORMS=cpu python tools/compare_safety_with_jax.py --seeds 256

Run from the root of the repo. Both sides run their plain CPU paths.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cilqr_tpu import pipeline as JP  # noqa: E402
from cilqr_tpu import scenario as JS  # noqa: E402
from cilqr_tpu.config import PlannerConfig as JPlannerConfig  # noqa: E402
from cilqr_tpu_torch import dp as TD  # noqa: E402
from cilqr_tpu_torch import pipeline as TP  # noqa: E402
from cilqr_tpu_torch import scenario as TS  # noqa: E402
from cilqr_tpu_torch.config import PlannerConfig  # noqa: E402

CHUNK = 64
NEAR = TP.NEAR_TERM_KNOTS


def counters(pre_hits, repaired, still_dirty, first):
    dirty = np.asarray(pre_hits)[:, :NEAR].any(1)
    return {"dirty": int(dirty.sum()),
            "repaired": int(np.asarray(repaired).sum()),
            "still_dirty": int(np.asarray(still_dirty).sum()),
            "dirty_lanes": (np.nonzero(dirty)[0] + first).tolist()}


def jax_chunk(seeds, jplan):
    scns = JS.make_scenario_batch(seeds, dtype=jnp.float32)
    starts = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 10.0], jnp.float32),
                      (len(seeds), 1))
    out = jplan(scns, starts)
    return counters(out.pre_hits, out.repaired, out.still_dirty, seeds[0])


def port_chunk(seeds, cfg, lane, spec):
    scns = TS.make_scenario_batch(seeds, dtype=torch.float32, device="cpu")
    starts = torch.tensor([[0.0, 0.0, 0.0, 10.0]] * len(seeds),
                          dtype=torch.float32)
    out = TP.plan_batch(scns, starts, cfg, None, lane, spec=spec)
    return counters(out.pre_hits, out.repaired, out.still_dirty, seeds[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=256)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    # the port's DP in chunks of 16 scenarios (its lanes do not depend on
    # the chunk), to bound the CPU's memory
    TD.PROBES_PER_CHUNK = 16 * 70 * 70 * 16
    jcfg = JPlannerConfig()
    cfg = PlannerConfig()
    scn0 = JS.make_scenario(0, dtype=jnp.float32)
    jlane = JP.make_lane_tuple(scn0.left_barrier_xy, scn0.right_barrier_xy,
                               jcfg, np.float32)
    jspec = JS.analytic_road_spec(dtype=np.float32)
    jplan = jax.jit(lambda s, st: JP.plan_batch(s, st, jcfg, None, jlane,
                                                spec=jspec))
    lane = TP.make_lane_tuple(np.asarray(scn0.left_barrier_xy),
                              np.asarray(scn0.right_barrier_xy), cfg,
                              np.float32)
    spec = TS.analytic_road_spec(dtype=np.float32)
    rows = []
    for k in range(0, args.seeds, CHUNK):
        seeds = list(range(k, min(args.seeds, k + CHUNK)))
        t0 = time.perf_counter()
        j = jax_chunk(seeds, jplan)
        t1 = time.perf_counter()
        p = port_chunk(seeds, cfg, lane, spec)
        t2 = time.perf_counter()
        rows.append({"seeds": [seeds[0], seeds[-1]], "jax": j, "port": p,
                     "jax_s": t1 - t0, "port_s": t2 - t1})
        print(f"seeds {seeds[0]}..{seeds[-1]}: jax {j} ({t1 - t0:.1f} s); "
              f"port {p} ({t2 - t1:.1f} s)", flush=True)
    total = {side: {key: sum(r[side][key] for r in rows)
                    for key in ("dirty", "repaired", "still_dirty")}
             for side in ("jax", "port")}
    print(json.dumps({"chunks": rows, "total": total}), flush=True)


if __name__ == "__main__":
    main()
