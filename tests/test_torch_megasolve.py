"""The port's full-solve megakernel path (kernels/megasolve.py) against the
JAX package, float64 on the CPU, where the wrapper takes its plain version.

Held against JAX's Pallas megakernel in interpret mode (fixture problems 0
and 1, the fixture's unused constraint slots trimmed, block_nb=2:
decisions identical, controls within 1e-8, cost rtol 1e-9, lambda rtol
1e-12 -- the two sum the cost stack in other orders) and
against JAX's batch-last solver with the full lane scan (lane_window=0) on
16 fixture problems, the gate of test_torch_solve.py (>= 14/16 decisions
identical, max |du| <= 1e-6 on those). The loop exits per block, as the
Pallas kernel's does: a lane past max_iter_num keeps iterating while a
neighbour of its block runs, and the port reproduces the overrun."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu.config import PlannerConfig as JPlannerConfig
from cilqr_tpu.costs import ConstraintSet as JConstraintSet
from cilqr_tpu.costs import trim_constraints
from cilqr_tpu.pallas.megasolve import _fold_constraints as jax_fold
from cilqr_tpu.pallas.megasolve import solve_batch_mega as jax_mega
from cilqr_tpu.solver_blast import solve_batch_bl as jax_blast
from cilqr_tpu_torch import batch as TB
from cilqr_tpu_torch import profiling as TPr
from cilqr_tpu_torch.config import PlannerConfig
from cilqr_tpu_torch.convert import FIXTURE, constraints_from_numpy
from cilqr_tpu_torch.kernels import megasolve as TM
from cilqr_tpu_torch.solver import iqr_init, transform_goals
from cilqr_tpu_torch.types import SolverStatus

torch.set_num_threads(1)

CFG = PlannerConfig()
JCFG = JPlannerConfig()
N_FIX = 16


@pytest.fixture(scope="module")
def raw():
    """The first N_FIX fixture problems as numpy arrays (masks bool), their
    constraint slots that no problem uses trimmed (exact: everything
    dropped is masked out), which halves the interpret-mode runs."""
    d = np.load(FIXTURE)
    cons = trim_constraints(JConstraintSet(
        *(d[k][:N_FIX] for k in JConstraintSet._fields)))
    return {"goals": d["goals"][:N_FIX], "starts": d["starts"][:N_FIX],
            **{k: np.asarray(v) for k, v in zip(JConstraintSet._fields,
                                                  cons)}}


def _jax_inputs(raw, n):
    def jx(a):
        return jnp.asarray(a[:n], None if a.dtype == np.bool_
                           else jnp.float64)

    return (jx(raw["goals"]), jx(raw["starts"]),
            JConstraintSet(*(jx(raw[k]) for k in JConstraintSet._fields)))


def _torch_inputs(raw, n):
    return (torch.tensor(raw["goals"][:n], dtype=torch.float64),
            torch.tensor(raw["starts"][:n], dtype=torch.float64),
            constraints_from_numpy([raw[k][:n] for k in
                                    JConstraintSet._fields],
                                   torch.float64, "cpu"))


def _ilqr(**kw):
    return (dataclasses.replace(CFG.ilqr, **kw),
            dataclasses.replace(JCFG.ilqr, **kw))


@pytest.fixture(scope="module")
def jax_mega_01(raw):
    """JAX's megakernel in interpret mode on problems 0 and 1, block_nb=2
    (about 30 s)."""
    return jax_mega(*_jax_inputs(raw, 2), JCFG.ilqr, JCFG.vehicle,
                    JCFG.delta_t, interpret=True, block_nb=2)


def test_mega_matches_jax_megakernel(raw, jax_mega_01):
    rj = jax_mega_01
    before = TPr.counters["solve_batch_mega.launches"]
    rt = TM.solve_batch_mega(*_torch_inputs(raw, 2), CFG.ilqr, CFG.vehicle,
                             CFG.delta_t, block_nb=2)
    # the CPU takes the plain version
    assert TPr.counters["solve_batch_mega.launches"] == before
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.iters.numpy(), [12, 6])
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), atol=1e-8)
    np.testing.assert_allclose(rt.xs.numpy(), np.asarray(rj.xs), atol=1e-7)
    for name in ("total", "target", "dynamic", "corridor", "lane"):
        np.testing.assert_allclose(getattr(rt.cost, name).numpy(),
                                   np.asarray(getattr(rj.cost, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(rt.lam.numpy(), np.asarray(rj.lam),
                               rtol=1e-12)
    np.testing.assert_allclose(rt.init_us.numpy(), np.asarray(rj.init_us),
                               atol=1e-10)
    assert not rt.lane_clipped.any()


def test_mega_overruns_max_iter_per_block(raw):
    """max_iter_num=4, block_nb=2: lane 0 reaches the cap while lane 1 is
    still running and takes 2 more iterations; JAX's batch-last solver,
    which exits per lane, stops both at 4."""
    ilqr, jilqr = _ilqr(max_iter_num=4)
    rj = jax_mega(*_jax_inputs(raw, 2), jilqr, JCFG.vehicle, JCFG.delta_t,
                  interpret=True, block_nb=2)
    rt, trips = TM._solve(TM.solve_batch_mega_ref, *_torch_inputs(raw, 2),
                          ilqr, CFG.vehicle, CFG.delta_t, None, 2)
    np.testing.assert_array_equal(np.asarray(rj.iters), [6, 4])
    np.testing.assert_array_equal(rt.iters.numpy(), [6, 4])
    np.testing.assert_array_equal(rt.status.numpy(), [5, 5])
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), atol=1e-8)
    np.testing.assert_allclose(rt.lam.numpy(), np.asarray(rj.lam),
                               rtol=1e-12)
    assert trips.tolist() == [12]


@pytest.mark.parametrize("max_iter", [None, 4])
def test_relinearizations_counted(raw, monkeypatch, max_iter):
    """istate's fourth row counts the trips on which a lane relinearized:
    its first trip and each one after a concluded trip, never a retry at
    the next alpha. Problems 0-1 in one block of 2, to convergence and at
    the cap of 4 (where lane 0 overruns): the count equals the iterations
    on a lane whose last trip concluded, exceeds them by at most one on a
    lane left mid-search at the cap, and lane_trips - relins equals the
    retries, counted here from the alpha of each rollout."""
    kw = {} if max_iter is None else dict(max_iter_num=max_iter)
    ilqr, _ = _ilqr(**kw)
    alphas = []
    forward = TM._forward

    def record(alpha, *args):
        alphas.append(alpha.clone())
        return forward(alpha, *args)

    monkeypatch.setattr(TM, "_forward", record)
    ops = TM._operands(*_torch_inputs(raw, 2), ilqr, CFG.vehicle,
                       CFG.delta_t, None, 2)[0]
    _, _, _, ist, trips = TM.solve_batch_mega_ref(*ops, ilqr, CFG.vehicle,
                                                  CFG.delta_t, 2)
    status, iters, lane_trips, relins = ist.tolist()
    assert len(alphas) == trips.item()
    # one block: a lane runs from the first trip until it stops
    retries = [sum(float(a[j]) != ilqr.line_search.alphas[0]
                   for a in alphas[:lane_trips[j]]) for j in range(2)]
    assert [t - r for t, r in zip(lane_trips, relins)] == retries
    for j in range(2):
        if status[j] == int(SolverStatus.MAX_ITER):
            assert iters[j] <= relins[j] <= iters[j] + 1
        else:
            assert relins[j] == iters[j]
    assert sum(retries) > 0
    if max_iter is None:
        assert iters == [12, 6] and status != [5, 5]
    else:
        assert iters == [6, 4] and status == [5, 5]


def test_mega_matches_jax_blast_fixture(raw):
    """16 fixture problems in one block against JAX's batch-last solver
    with the full lane scan, in one phase: its compaction cascade decides
    every lane as one phase does (tests/test_torch_solve.py) and would
    compile a solve for each cascade width."""
    ilqr, jilqr = _ilqr(sweep_backend="xla", lane_window=0,
                        compaction_phase1=0)
    rj = jax_blast(*_jax_inputs(raw, N_FIX), jilqr, JCFG.vehicle,
                   JCFG.delta_t)
    rt = TM.solve_batch_mega(*_torch_inputs(raw, N_FIX), CFG.ilqr,
                             CFG.vehicle, CFG.delta_t, block_nb=N_FIX)
    st_j, it_j = np.asarray(rj.status), np.asarray(rj.iters)
    assert np.isin(rt.status.numpy(), (1, 2, 3)).all()
    same = (rt.status.numpy() == st_j) & (rt.iters.numpy() == it_j)
    assert same.sum() >= 14, int(same.sum())
    du = np.abs(rt.us.numpy() - np.asarray(rj.us)).max(axis=(1, 2))
    assert du[same].max() <= 1e-6, float(du[same].max())


def test_solve_batch_backend_mega_on_cpu(raw):
    """batch.solve_batch(backend='mega') on CPU tensors takes the plain
    version (no launch) with the default block of 128: 2 lanes padded with
    126 copies of lane 0, which decide as lane 0 does, so each lane ends as
    in a block of 2."""
    g, s, c = _torch_inputs(raw, 2)
    ilqr, _ = _ilqr(max_iter_num=1)
    before = TPr.counters["solve_batch_mega.launches"]
    rt = TB.solve_batch(g, s, c, ilqr, CFG.vehicle, CFG.delta_t,
                        backend="mega")
    assert TPr.counters["solve_batch_mega.launches"] == before
    ops = TM._operands(g, s, c, ilqr, CFG.vehicle, CFG.delta_t, None,
                       TM.NB)[0]
    assert all(a.shape[-1] == TM.NB for a in ops)
    assert rt.us.shape == (2, 80, 2) and rt.xs.shape == (2, 81, 6)
    assert torch.isfinite(rt.xs).all() and (rt.status != 0).all()
    r2 = TM.solve_batch_mega(g, s, c, ilqr, CFG.vehicle, CFG.delta_t,
                             block_nb=2)
    assert torch.equal(rt.status, r2.status)
    assert torch.equal(rt.iters, r2.iters)
    np.testing.assert_allclose(rt.us.numpy(), r2.us.numpy(), atol=1e-10)


def test_padding_keeps_per_lane_results(raw):
    """6 lanes as blocks of 4 (the second padded with 2 copies of lane 0)
    and as one block of 8: where no lane reaches max_iter_num, a lane's
    result does not depend on its block."""
    args = _torch_inputs(raw, 6)
    r4, trips4 = TM._solve(TM.solve_batch_mega_ref, *args, CFG.ilqr,
                           CFG.vehicle, CFG.delta_t, None, 4)
    r8, trips8 = TM._solve(TM.solve_batch_mega_ref, *args, CFG.ilqr,
                           CFG.vehicle, CFG.delta_t, None, 8)
    assert trips4.shape == (2,) and trips8.shape == (1,)
    assert (r4.iters < CFG.ilqr.max_iter_num).all()
    assert r4.us.shape == (6, 80, 2)
    assert torch.equal(r4.status, r8.status)
    assert torch.equal(r4.iters, r8.iters)
    np.testing.assert_allclose(r4.us.numpy(), r8.us.numpy(), atol=1e-10)
    np.testing.assert_allclose(r4.lam.numpy(), r8.lam.numpy(), rtol=1e-12)
    np.testing.assert_allclose(r4.cost.total.numpy(), r8.cost.total.numpy(),
                               rtol=1e-10)


def test_warm_start_passes_through(raw):
    g, s, c = _torch_inputs(raw, 2)
    ilqr, _ = _ilqr(max_iter_num=2)
    veh, dt = CFG.vehicle, CFG.delta_t
    cold = TM.solve_batch_mega(g, s, c, ilqr, veh, dt, block_nb=2)
    warm = (cold.init_xs.clone(), cold.init_us.clone())
    r = TM.solve_batch_mega(g, s, c, ilqr, veh, dt, warm_start=warm,
                            block_nb=2)
    assert r.init_xs is warm[0] and r.init_us is warm[1]
    assert torch.equal(r.us, cold.us) and torch.equal(r.iters, cold.iters)
    # a warm start elsewhere: the solve starts from it
    xs0, us0 = iqr_init(transform_goals(g, s), ilqr, veh, dt)
    assert torch.equal(xs0, cold.init_xs)
    moved = (xs0, us0 + 0.01)
    r2 = TM.solve_batch_mega(g, s, c, ilqr, veh, dt, warm_start=moved,
                             block_nb=2)
    assert torch.equal(r2.init_us, moved[1])
    assert not torch.equal(r2.us, cold.us)


def test_rejects_other_barriers_and_bad_inputs(raw):
    g, s, c = _torch_inputs(raw, 2)
    veh, dt = CFG.vehicle, CFG.delta_t
    for kind in ("exponential", "quadratic"):
        bar = dataclasses.replace(CFG.ilqr.barrier, kind=kind)
        ilqr = dataclasses.replace(CFG.ilqr, barrier=bar)
        with pytest.raises(ValueError, match="barrier kind"):
            TM.solve_batch_mega(g, s, c, ilqr, veh, dt)
        with pytest.raises(ValueError, match="barrier kind"):
            TB.solve_batch(g, s, c, ilqr, veh, dt, backend="mega")
    with pytest.raises(ValueError, match="dtype"):
        TM.solve_batch_mega(g.half(), s, c, CFG.ilqr, veh, dt)
    with pytest.raises(ValueError, match="starts"):
        TM.solve_batch_mega(g, s.float(), c, CFG.ilqr, veh, dt)
    with pytest.raises(ValueError, match="goals"):
        TM.solve_batch_mega(g[..., :4], s, c, CFG.ilqr, veh, dt)
    with pytest.raises(ValueError, match="batch"):
        TM.solve_batch_mega(g, s, c.map(lambda a: a[:1]), CFG.ilqr, veh, dt)
    with pytest.raises(ValueError, match="block_nb"):
        TM.solve_batch_mega(g, s, c, CFG.ilqr, veh, dt, block_nb=0)


def test_lane_scan_first_minimum_and_nan():
    """The nearest-segment scan is a strict running minimum seeded with
    segment 0, as in the Pallas kernel: a tie keeps the first segment, a
    later segment at a NaN distance is never selected, and a NaN distance
    at segment 0 (a NaN disc centre, say) keeps segment 0."""
    segs = [(0.0, 0.0, 1.0, 0.0), (50.0, 50.0, 51.0, 50.0),
            (0.0, 0.0, 1.0, 0.0)]                   # segment 2 repeats 0
    planes = [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 9.0]]
    lane = torch.tensor(planes + [[s_[i] for s_ in segs] for i in range(4)],
                        dtype=torch.float64)[:, :, None]       # [7, S, 1]
    cx = torch.tensor([0.5, float("nan"), 50.5],
                      dtype=torch.float64).view(3, 1, 1)     # [D, N, B]
    cy = torch.tensor([1.0, 0.0, 51.0], dtype=torch.float64).view(3, 1, 1)
    sa, sb, sc = TM._select_lane(cx, cy, lane)
    assert sa.flatten().tolist() == [1.0, 1.0, 2.0]
    assert sc.flatten().tolist() == [7.0, 7.0, 8.0]
    mid = lane.clone()
    mid[3:, 1] = float("nan")             # segment 1 at a NaN distance
    assert TM._select_lane(cx, cy, mid)[0].flatten().tolist() == [1.0] * 3
    first = lane.clone()
    first[3:, 0] = float("nan")           # the seed NaN: segment 0 stays
    assert TM._select_lane(cx, cy, first)[0].flatten().tolist() == [1.0] * 3


def test_fold_constraints_matches_jax(raw):
    jc = _jax_inputs(raw, 4)[2]
    tc = _torch_inputs(raw, 4)[2]
    want = jax_fold(jc, jnp.float64)
    got = TM._fold_constraints(tc, torch.float64)
    assert len(got) == len(want) == 5
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    # some slots of the fixture are invalid, so the fold is exercised
    assert (got[3][:, 3] == TM.FAR).any() and (got[2] == 1.0).any()

