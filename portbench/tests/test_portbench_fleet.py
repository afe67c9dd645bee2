"""The two cells of kinds ``replan_online`` and ``replan_fleet``: each
loads through the registry and runs on the CPU at a small size, correct;
the fleet's comparison reads a fault that hands each lane the next lane's
road as not correct, through ``lanes_off``; and the fleet's reference and
inputs import nothing of the program."""

import pathlib
import subprocess
import sys

import pytest

from portbench import calibrate_kinds, fleet, fleet_ref, guard, registry, run

from . import small

CELLS = ("pedtest_spec.replan_online", "pedtest_fleet.replan_fleet")


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_and_runs_small(name):
    cell = registry.cell(name)
    assert cell.traffic["kind"] == name.split(".")[1]
    for f in ("setup", "window", "failed", "end_to_end", "profiled",
              "check", "control_check"):
        assert callable(getattr(cell.kind(), f)), f
    res = run.run(name, 2**31 + 31, 0.0, False, device="cpu",
                  cell=small.cell(name))
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["failed"] == 0 and res["attempted"] >= 4


def test_rotated_roads_are_not_correct():
    """Each lane handed the next lane's road: its DP, corridors and
    constraints depart from its own road's reference."""
    name = "pedtest_fleet.replan_fleet"
    restore = calibrate_kinds.plant_rotate()
    try:
        res = run.run(name, 2**31 + 37, 0.0, False, device="cpu",
                      cell=small.cell(name))
    finally:
        restore()
    assert res["correct"] is False
    c = res["checks"]["lanes_off"]
    assert c["value"] > c["limit"], res["checks"]


def test_fleet_reference_imports_nothing_of_the_program():
    for mod in (fleet, fleet_ref):
        names = list(guard.imported_names(pathlib.Path(mod.__file__)))
        assert not guard.loaded_forbidden(
            dict.fromkeys(names), guard.FORBIDDEN_IN_REFERENCE), names
    code = ("import sys, portbench.fleet_ref\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cilqr_tpu_torch', 'cilqr_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=registry.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_fleet_inputs_follow_the_seed():
    """The same seed gives the same roads and arrays; another seed other
    roads, each at least the upstream road's length."""
    conf = registry.cell("pedtest_fleet.replan_fleet").config
    a1, r1 = fleet.fleet_arrays(conf, 2**31 + 5, 3)
    a2, r2 = fleet.fleet_arrays(conf, 2**31 + 5, 3)
    _, r3 = fleet.fleet_arrays(conf, 2**31 + 6, 3)
    assert r1 == r2 and r1 != r3
    assert (a1["barrier_xy"] == a2["barrier_xy"]).all()
    s = a1["centerline"]["s"]
    assert (s.max(-1) >= 195.0).all()
    assert len(set(map(len, (fleet.lane_arrays(a1, [r])["barrier_xy"][0]
                             for r in range(3))))) == 3


def test_online_draws_are_fresh_every_call():
    """Each call of the online cell replans distinct pool scenarios, a new
    draw every call; the same seed draws the same, another seed others."""
    from portbench.kinds import replan_online

    cell = registry.cell("pedtest_spec.replan_online")
    d = replan_online.draws(cell, 2**31 + 41)
    n, b = replan_online.pool_size(cell), cell.traffic["batch"]
    assert d.shape == (replan_online.PERTURBATION_ROWS, b)
    assert all(len(set(row)) == b for row in d)
    assert d.min() >= 0 and d.max() < n and n > b
    assert len({tuple(sorted(row)) for row in d}) == len(d)
    assert (d == replan_online.draws(cell, 2**31 + 41)).all()
    assert not (d == replan_online.draws(cell, 2**31 + 42)).all()


def test_fleet_reference_roads_in_threads_equal_one_at_a_time():
    """The reference's roads run in threads; each road's problem equals
    the one computed alone, bit for bit."""
    import numpy as np
    import torch

    cell = small.cell("pedtest_fleet.replan_fleet", batch=3)
    arrays, _ = fleet.fleet_arrays(cell.config, 2**31 + 43, 3)
    starts = torch.tensor([[0.0, 0.1 * i, 0.0, 10.0] for i in range(3)],
                          dtype=torch.float32)
    lanes, groups = fleet_ref.sample(cell, 2**31 + 43, np.arange(3))
    threaded = fleet_ref.problems(cell, arrays, starts, lanes, groups, "cpu")
    saved = fleet_ref.THREADS
    fleet_ref.THREADS = 1
    try:
        alone = fleet_ref.problems(cell, arrays, starts, lanes, groups,
                                   "cpu")
    finally:
        fleet_ref.THREADS = saved
    for (_, a), (_, b) in zip(threaded, alone):
        assert torch.equal(a.goals, b.goals)
        assert torch.equal(a.dp_ok, b.dp_ok)
        for x, y in zip(a.cons, b.cons):
            assert torch.equal(x, y)
