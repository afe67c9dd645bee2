"""The port's DP against the reference planner's numpy transcription
(tests/dp_oracle.py: dp_planner.cpp:39-320 and the environment and
reference-line code it calls), as tests/test_dp.py holds the JAX package's
DP: exact collision mode (every road-barrier point), float64 on the CPU,
no JAX.

The oracle takes ~50 s a scenario on a CPU, so its results are read from
tests/data/dp_oracle.npz, written by ``tools/dp_oracle_fixture.py`` from
the same scenarios. Seeds, as in tests/test_dp.py: 0 changes lane and
station around obstacles, 2 weaves laterally."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cilqr_tpu_torch import dp as TD
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch.config import PlannerConfig

CFG = PlannerConfig()
CFG_EXACT = dataclasses.replace(
    CFG, dp=dataclasses.replace(CFG.dp, collision_mode="exact"))
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "dp_oracle.npz")


@pytest.fixture(scope="module")
def oracle():
    with np.load(FIXTURE) as f:
        return dict(f)


@pytest.mark.parametrize("seed", [0, 2])
def test_dp_matches_oracle(oracle, seed):
    scn = TS.make_scenario(seed, dtype=torch.float64, device="cpu")
    z = torch.zeros(1, dtype=torch.float64)
    got = TD.plan(scn.map(lambda a: a[None]), z, z, z, CFG_EXACT)

    def want(key):
        return oracle[f"{seed}/{key}"]

    # winning cells exactly (another cell is another coarse plan, and every
    # corridor and solve downstream changes)
    cells = np.stack([got.sel_s[0].numpy(), got.sel_l[0].numpy()], -1)
    np.testing.assert_array_equal(cells, want("sel_cells"))
    np.testing.assert_allclose(float(got.min_cost[0]), want("min_cost"),
                               rtol=1e-9)
    assert bool(got.ok[0]) == bool(want("ok"))
    # the 81-knot coarse trajectory to round-off, at tests/test_dp.py's
    # tolerances
    for f, tol in (("s", 1e-9), ("x", 1e-9), ("y", 1e-9), ("theta", 1e-9),
                   ("velocity", 1e-8), ("a", 1e-7), ("kappa", 1e-9),
                   ("delta", 1e-9)):
        np.testing.assert_allclose(getattr(got.traj, f)[0].numpy(), want(f),
                                   rtol=0, atol=tol, err_msg=f)
