"""The port's multi-card layer (dist.py) and ``run dist`` on the CPU: gloo
ranks started with the spawn method (dist.launch_local), meeting through a
file store in the test's temporary directory, float64.

- sharded_solve_step, 2 ranks, against the JAX package's
  dist.sharded_solve_step on tests/conftest.py's 8 virtual CPU devices, on
  tests/test_batch_dist.py's 16 straight-goal problems: the stats equal
  (cost_sum, a float32 sum of float64 costs, to rtol 1e-6), every lane's
  status and iterations equal and its controls within 1e-9.
- sharded_pipeline_step, then one cycle of sharded_mpc_step, 2 ranks on
  torch_shared.SEEDS at torch_shared.replan_config(), against the
  unsharded port (torch_shared.replan, and a one-cycle mpc_scan_batch from
  its plans; both held against JAX elsewhere). The replan: statuses,
  iterations and every count equal lane for lane; controls within 1e-9
  and costs to rtol 1e-9 on every lane but seed 156's; cost_sum the sum of
  the ranks' lane costs. Seed 156 forks by width: each rank solves 2
  lanes, the unsharded replan 4, and the CPU's arithmetic is not the same
  at both widths (lanes 0-2 move by 1e-13 to 4e-11; at width 4 the lane's
  result does not depend on its position or its neighbours), and its
  solve is threshold-chaotic (its iterations differ even between JAX's
  jitted and op-by-op runs): 3.9e-7 in its controls before the repair,
  3.2e-3 after the warm repair re-solve; its cost is held to rtol 5e-2,
  chip_smoke's cost_sum gate. The MPC cycle, from the unsharded plans on
  both sides: the final carry within 1e-9 on every lane, no_repair and
  every stat equal.
- shard_batch / global_batch with no process group and in a world of one;
  the mismatch of unequal shards across two ranks (in the solve test).
- NCCL asked for a rank without a card raises.
- ``run dist --cpu --devices 2 --batch 4 --f64`` exits 0 and its stats
  equal an unsharded plan_batch's sums.

Every spawned rank, and the CLI's process, has a timeout.
"""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cilqr_tpu import dist as JD
from cilqr_tpu.config import PlannerConfig as JPlannerConfig
from cilqr_tpu_torch import dist as D
from cilqr_tpu_torch import mpc as TM
from cilqr_tpu_torch import pipeline as TP
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch.batch import device_metrics
from cilqr_tpu_torch.config import PlannerConfig

import torch_dist_worker
import torch_shared
from test_batch_dist import _batched_problem

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
RANK_TIMEOUT_S = 600.0
CPU = torch.device("cpu")
DIRTY = torch_shared.SEEDS.index(156)
STABLE = [i for i in range(len(torch_shared.SEEDS)) if i != DIRTY]


def _ranks(fn, tmp_path, *args, world=2):
    """fn(rank, world, tmp_path, *args) in ``world`` spawned ranks; what
    each saved."""
    D.launch_local(fn, world, (world, str(tmp_path), *args),
                   timeout=RANK_TIMEOUT_S)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def _cat(parts, key):
    return torch.cat([p[key] for p in parts])


def _stats(d):
    return {k: float(v) for k, v in d.items()}


def _replan_stats(out):
    """sharded_pipeline_step's statistics of a PlanOutput, summed
    directly."""
    near = out.pre_hits[:, :TP.NEAR_TERM_KNOTS].any(-1)
    return {**device_metrics(out.solve), "dp_ok": out.dp_ok.sum(),
            "ok": out.ok.sum(), "near_hit_lanes": near.sum(),
            "repaired_lanes": out.repaired.sum(),
            "still_dirty_lanes": out.still_dirty.sum()}


def _assert_stats(got, want):
    """Counts exactly; cost sums (float32 sums of float64 costs, in
    another order) to rtol 1e-6."""
    got, want = _stats(got), _stats(want)
    assert list(got) == list(want)
    for k in want:
        if k == "cost_sum":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        else:
            assert got[k] == want[k], (k, got[k], want[k])


def test_sharded_solve_step_matches_jax(tmp_path):
    gb, sb, cb = _batched_problem(16)
    mesh = JD.make_batch_mesh(jax.devices()[:8])
    jres, jstats = JD.sharded_solve_step(JPlannerConfig(), mesh)(
        *JD.shard_batch(mesh, (gb, sb, cb)))

    parts = _ranks(torch_dist_worker.solve_rank, tmp_path, np.asarray(gb),
                   np.asarray(sb), [np.asarray(c) for c in cb])
    for p in parts:
        assert "unequal row counts [8, 7]" in p["mismatch"], p["mismatch"]
    stats = parts[0]["stats"]
    assert set(stats) == set(jstats)
    for k in jstats:
        assert stats[k].dtype == torch.float32
        assert torch.equal(parts[1]["stats"][k], stats[k])
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-6 if k == "cost_sum" else 0)
    np.testing.assert_array_equal(_cat(parts, "status").numpy(),
                                  np.asarray(jres.status))
    np.testing.assert_array_equal(_cat(parts, "iters").numpy(),
                                  np.asarray(jres.iters))
    np.testing.assert_allclose(_cat(parts, "us").numpy(),
                               np.asarray(jres.us), rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def unsharded(request, tmp_path_factory):
    """The port's replan on SEEDS (torch_shared) and one MPC cycle from
    its plans, unsharded."""
    cfg = torch_shared.replan_config()
    out = torch_shared.replan(request, tmp_path_factory)
    scns = TS.make_scenario_batch(torch_shared.SEEDS, dtype=F64,
                                  device="cpu")
    lane = TP.make_lane_tuple(scns.left_barrier_xy[0],
                              scns.right_barrier_xy[0], cfg)
    carry = TM.MpcCarry(xs=out.solve.xs, us=out.solve.us,
                        cycle_time=torch.zeros(len(torch_shared.SEEDS),
                                               dtype=F64))
    final, st = TM.mpc_scan_batch(scns, carry, cfg, lane, 1,
                                  spec=TS.analytic_road_spec(
                                      dtype=np.float64))
    return out, final, st


def test_sharded_replan_and_mpc_match_unsharded(tmp_path, unsharded):
    out, final, st = unsharded
    cfg = torch_shared.replan_config()
    parts = _ranks(torch_dist_worker.replan_rank, tmp_path,
                   torch_shared.SEEDS, cfg, out.solve.xs, out.solve.us)
    assert bool(out.pre_hits[DIRTY, :TP.NEAR_TERM_KNOTS].any())
    assert bool(out.repaired[DIRTY])

    assert torch.equal(_cat(parts, "status"), out.solve.status)
    assert torch.equal(_cat(parts, "iters"), out.solve.iters)
    du = (_cat(parts, "us") - out.solve.us).abs().amax(dim=(1, 2))
    assert (du[STABLE] <= 1e-9).all(), du
    cost, want = _cat(parts, "cost"), out.solve.cost.total
    np.testing.assert_allclose(cost[STABLE], want[STABLE], rtol=1e-9)
    np.testing.assert_allclose(cost[DIRTY], want[DIRTY], rtol=5e-2)
    for p in parts:
        _assert_stats(p["stats"], {**_replan_stats(out),
                                   "cost_sum": cost.sum()})

    assert torch.equal(_cat(parts, "mpc_no_repair"), final.no_repair)
    for key, have in (("mpc_us", final.us), ("mpc_xs", final.xs)):
        err = (_cat(parts, key) - have).abs().amax(dim=(1, 2))
        assert (err <= 1e-9).all(), (key, err)
    s = st.status
    succ = (s == 1) | (s == 2) | (s == 3)
    mwant = {"cycles": s.numel(), "converged_cycles": succ.sum(),
             "lambda_fail_cycles": (s == 4).sum(), "iters_sum": st.iters.sum(),
             "corridor_ok_cycles": st.corridor_ok.sum(),
             "lane_clipped": st.lane_clipped.sum(),
             "near_hit_cycles": st.pre_near_hits.sum(),
             "repaired_cycles": st.repaired.sum(),
             "still_dirty_cycles": st.still_dirty.sum()}
    for p in parts:
        _assert_stats(p["mpc_stats"], mwant)


def test_shard_batch_without_a_group():
    """No process group: a mesh of this process alone, every row; a mesh
    of 2 (as a rank of a group sees it) takes its block."""
    mesh = D.make_batch_mesh("cpu")
    assert mesh == D.BatchMesh(None, 0, 1, CPU)
    a = torch.arange(12.0).reshape(6, 2)
    tree = (a, [a[:, 0], None])
    got = D.shard_batch(mesh, tree)
    assert torch.equal(got[0], a) and got[1][1] is None
    for rank in (0, 1, 2):
        got = D.shard_batch(D.BatchMesh(None, rank, 3, CPU), tree)
        assert torch.equal(got[0], a[2 * rank:2 * rank + 2])
        assert torch.equal(got[1][0], a[2 * rank:2 * rank + 2, 0])
    with pytest.raises(ValueError, match="does not divide over 4"):
        D.shard_batch(D.BatchMesh(None, 0, 4, CPU), tree)
    # numpy leaves become tensors on the mesh's device
    assert torch.equal(D.global_batch(mesh, np.ones((3, 2))),
                       torch.ones(3, 2, dtype=F64))
    with pytest.raises(ValueError, match="unequal row counts"):
        D.global_batch(mesh, (a, a[:5]))


def test_world_of_one(tmp_path):
    """A gloo group of one rank in this process: the mesh sees it, the
    helpers keep every row, and the stats go through all_reduce
    unchanged."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
        rank=0)
    try:
        mesh = D.make_batch_mesh("cpu")
        assert (mesh.rank, mesh.size, mesh.device) == (0, 1, CPU)
        assert mesh.group is not None
        a = torch.arange(8.0).reshape(4, 2)
        assert torch.equal(D.shard_batch(mesh, a), a)
        assert torch.equal(D.global_batch(mesh, a), a)
        with pytest.raises(ValueError, match="unequal row counts"):
            D.global_batch(mesh, [a, a[:3]])
        stats = {"n": torch.tensor(4.0), "cost_sum": torch.tensor(1.5)}
        assert D._all_reduce(mesh, stats) == stats
    finally:
        torch.distributed.destroy_process_group()
    assert D.make_batch_mesh("cpu").group is None


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D.rank_card(0) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="rank 1 .* has no card"):
        D.rank_card(1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert D.rank_card(5) == torch.device("cuda", 0)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="has no card"):
        D.init_distributed("localhost:1", 2, 0)     # NCCL: the default


def test_cli_dist_two_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "cilqr_tpu_torch.run", "dist", "--cpu",
         "--devices", "2", "--batch", "4", "--f64"],
        cwd=ROOT, capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line, = [ln for ln in proc.stdout.splitlines() if ln.startswith("mesh=")]
    assert line.startswith("mesh=2 batch=4 "), line
    assert "'n': 4.0" in line, line
    stats = ast.literal_eval(line[line.index("stats=") + len("stats="):])

    cfg = PlannerConfig()
    scns = TS.make_scenario_batch(range(4), dtype=F64, device="cpu")
    lane = TP.make_lane_tuple(scns.left_barrier_xy[0],
                              scns.right_barrier_xy[0], cfg)
    starts = torch.tensor(torch_shared.START, dtype=F64).repeat(4, 1)
    out = TP.plan_batch(scns, starts, cfg, None, lane,
                        spec=TS.analytic_road_spec(dtype=np.float64))
    _assert_stats(stats, _replan_stats(out))
