"""The port's MPC loop (mpc.py) and single-problem replan (pipeline.plan)
against the JAX package, float64 on the CPU.

Both MPC loops start from one carry: the port's plan_batch on seeds 0, 1,
2 and 156 (tests/test_torch_replan.py's configuration: no compaction
cascade, the repair ladder's first round), converted through numpy, with
``no_repair`` materialized so that one jit of JAX's mpc_step_batch serves
every call. Per cycle and lane: corridor_ok, lane_clipped, pre_near_hits,
near_hits, repaired, still_dirty and the carry's cycle_time and no_repair
identical; status and iterations identical on at least 3 of 4 lanes,
controls within 1e-6 on those (the accept tests are chaotic at their
thresholds). Seed 156 is near-term dirty in the MPC cycles too, so the
repair ladder runs; with no_repair set on it, it is neither attempted nor
cleared.

The single-vehicle loop (run_mpc, mpc_step) on seed 240 is held to
mpc_step_batch with backend="vmap" lane for lane (bit for bit), and its
initial pipeline.plan to JAX's plan on the same seed (decisions identical,
controls within 1e-6): seed 240's first plan is near-term dirty and its
repair ladder runs, with decisions that are stable against JAX's (seed
156's solve is not: its iterations differ even between JAX's jitted and
op-by-op runs). The single-lane repair is held to plan's, and with the
lane ineligible it is neither attempted nor cleared. The lane-window witnesses of tests/test_batch_dist.py
run on the port: no clip on the standard configuration over 8 cycles, a
clip every cycle with a 2-segment window of 1 m segments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import corridor as JC
from cilqr_tpu import mpc as JM
from cilqr_tpu import pipeline as JP
from cilqr_tpu import scenario as JS
from cilqr_tpu.config import PlannerConfig as JPlannerConfig
from cilqr_tpu.types import Traj as JTraj
from cilqr_tpu_torch import convert
from cilqr_tpu_torch import mpc as TM
from cilqr_tpu_torch import pipeline as TP
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch.config import PlannerConfig
from cilqr_tpu_torch.types import SolverStatus

import torch_shared

SEEDS = torch_shared.SEEDS
DIRTY = SEEDS.index(156)
SINGLE = 240
CFG = torch_shared.replan_config()
JCFG = JPlannerConfig()
JCFG = dataclasses.replace(
    JCFG, ilqr=dataclasses.replace(JCFG.ilqr, compaction_phase1=0),
    repair=dataclasses.replace(JCFG.repair, margins=JCFG.repair.margins[:1]))
F64 = torch.float64
START = (0.0, 0.0, 0.0, 10.0)
FLAGS = ("corridor_ok", "lane_clipped", "pre_near_hits", "near_hits",
         "repaired", "still_dirty")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.fixture(scope="module")
def batch(request, tmp_path_factory):
    """The port's replan on SEEDS (computed once a test run:
    torch_shared) and what both loops need."""
    scn = TS.make_scenario_batch(SEEDS, dtype=F64, device="cpu")
    lane = TP.make_lane_tuple(scn.left_barrier_xy[0], scn.right_barrier_xy[0],
                              CFG)
    spec = TS.analytic_road_spec(dtype=np.float64)
    out = torch_shared.replan(request, tmp_path_factory)
    carry = TM.MpcCarry(xs=out.solve.xs, us=out.solve.us,
                        cycle_time=torch.zeros(len(SEEDS), dtype=F64),
                        no_repair=torch.zeros(len(SEEDS), dtype=torch.bool))
    return scn, lane, spec, carry


def _to_jax(carry):
    return JM.MpcCarry(xs=jnp.asarray(_np(carry.xs)),
                       us=jnp.asarray(_np(carry.us)),
                       cycle_time=jnp.asarray(_np(carry.cycle_time)),
                       no_repair=jnp.asarray(_np(carry.no_repair)))


def _check_cycle(to, tc, jo, jc, same_cors, tag):
    """One cycle, port against JAX: the flags on every lane whose
    corridors agree (``same_cors``), the carry's times and no_repair
    flags, decisions on >= 3 of 4 lanes and controls on those."""
    for f in FLAGS:
        np.testing.assert_array_equal(_np(getattr(to, f))[same_cors],
                                      np.asarray(getattr(jo, f))[same_cors],
                                      err_msg=f"{tag} {f}")
    np.testing.assert_array_equal(_np(tc.cycle_time),
                                  np.asarray(jc.cycle_time))
    np.testing.assert_array_equal(_np(tc.no_repair)[same_cors],
                                  np.asarray(jc.no_repair)[same_cors])
    st, it = _np(to.solve.status), _np(to.solve.iters)
    assert (st != SolverStatus.RUNNING).all(), (tag, st)
    same = ((st == np.asarray(jo.solve.status))
            & (it == np.asarray(jo.solve.iters)))
    assert same.sum() >= 3, (tag, it, np.asarray(jo.solve.iters))
    du = np.abs(_np(to.solve.us) - np.asarray(jo.solve.us)).max(axis=(1, 2))
    assert du[same & same_cors].max() <= 1e-6, (tag, du)


def test_mpc_step_batch_matches_jax(batch):
    """Each cycle starts both sides from one carry (the port's, through
    numpy). Inside a jit XLA fuses multiply-adds, which can move a
    near-degenerate corridor hull decision (tests/test_torch_replan.py
    compares the corridors with JAX's op-by-op run for that reason); JAX's
    jitted corridors of the cycle are computed beside it, and the flags are
    held on every lane where they equal the port's (at least 3 of 4)."""
    scn, lane, spec, carry = batch
    jscn = JS.make_scenario_batch(SEEDS, dtype=jnp.float64)
    jspec = JS.analytic_road_spec(dtype=np.float64)
    jstep = jax.jit(lambda c: JM.mpc_step_batch(jscn, c, JCFG, lane,
                                                backend="blast", spec=jspec))

    def one_cors(s, g, t):
        pred = JTraj.zeros(g.shape[0], jnp.float64).replace(
            x=g[:, 0], y=g[:, 1], theta=g[:, 2], time=t)
        return JC.plan_corridors(s, pred, JCFG.corridor, lane)

    jcors = jax.jit(jax.vmap(one_cors))

    def step(tc, **kw):
        jc0 = _to_jax(tc)
        goals, _, t_new, cors, _ = TM._cycle_problem(scn, tc, CFG, lane)
        n = goals.shape[1]
        times = t_new[:, None] + CFG.delta_t * torch.arange(n, dtype=F64)
        jk = jcors(jscn, jnp.asarray(_np(goals)), jnp.asarray(_np(times)))
        same_cors = ((np.asarray(jk.plane_mask) == _np(cors.plane_mask))
                     .all(axis=(1, 2)))
        assert same_cors.sum() >= 3, same_cors
        tc, to = TM.mpc_step_batch(scn, tc, CFG, lane, spec=spec)
        jc, jo = jstep(jc0)
        _check_cycle(to, tc, jo, jc, same_cors, kw["tag"])
        return tc, to, jo, same_cors

    # the carry crosses back through convert as the JAX package holds it
    tc = convert.mpc_carry_from_numpy(_to_jax(carry), F64, "cpu")
    carries, outs, agree = [tc], [], []
    for cycle in range(2):
        tc, to, jo, same_cors = step(tc, tag=f"cycle {cycle}")
        carries.append(tc)
        outs.append(to)
        agree.append(same_cors)
    # the dirty seed is dirty before the repair in both cycles and
    # repaired (the ladder ran on the MPC path, t0 and eligible included),
    # and in cycle 1 its corridors agree with JAX's jit
    for o in outs:
        assert _np(o.pre_near_hits).tolist() == [
            i == DIRTY for i in range(len(SEEDS))]
        assert bool(o.repaired[DIRTY]) and not o.still_dirty.any()
    assert agree[1].all()
    res = convert.solve_result_from_numpy(jo.solve, F64, "cpu")
    assert torch.equal(res.us, outs[1].solve.us) or bool(
        (res.us - outs[1].solve.us).abs().max() <= 1e-6)

    # attempt-once: a lane flagged no_repair is neither attempted nor
    # cleared, on both sides (cycle 1's problem, where every lane's
    # corridors agree)
    nr = carries[1].replace(no_repair=torch.tensor(
        [i == DIRTY for i in range(len(SEEDS))]))
    tc, to, _, _ = step(nr, tag="no_repair")
    assert bool(to.pre_near_hits[DIRTY]) and bool(to.still_dirty[DIRTY])
    assert not bool(to.repaired[DIRTY]) and bool(tc.no_repair[DIRTY])

    # the scan is the step's loop, stats stacked [C, B]
    _, st = TM.mpc_scan_batch(scn, carry.replace(no_repair=None), CFG, lane,
                              1, spec=spec)
    assert st.iters.shape == (1, len(SEEDS))
    assert torch.equal(st.iters[0], outs[0].solve.iters)
    assert torch.equal(st.still_dirty[0], outs[0].still_dirty)


@pytest.fixture(scope="module")
def single():
    """run_mpc on SINGLE: the initial plan and 2 cycles."""
    scn = TS.make_scenario(SINGLE, dtype=F64, device="cpu")
    spec = TS.analytic_road_spec(dtype=np.float64)
    return scn, spec, TM.run_mpc(scn, START, CFG, 2, spec=spec)


def test_plan_matches_jax(single):
    scn, _, results = single
    jscn = JS.make_scenario(SINGLE, dtype=jnp.float64)
    jspec = JS.analytic_road_spec(dtype=np.float64)
    lane = JP.make_lane_tuple(jscn.left_barrier_xy, jscn.right_barrier_xy,
                              JCFG)
    jo = jax.jit(lambda s: JP.plan(s, START, JCFG, None, lane,
                                   spec=jspec))(jscn)
    to = TP.plan(scn, START, CFG, spec=TS.analytic_road_spec(
        dtype=np.float64))
    assert to.solve.xs.shape == (81, 6) and to.ok.dim() == 0
    for f in ("dp_ok", "ok", "repaired", "still_dirty"):
        assert bool(getattr(to, f)) == bool(getattr(jo, f)), f
    np.testing.assert_array_equal(_np(to.pre_hits), np.asarray(jo.pre_hits))
    np.testing.assert_allclose(_np(to.coarse.x), np.asarray(jo.coarse.x),
                               rtol=0, atol=1e-9)
    assert int(to.solve.status) == int(jo.solve.status)
    assert int(to.solve.iters) == int(jo.solve.iters)
    assert np.abs(_np(to.solve.us) - np.asarray(jo.solve.us)).max() <= 1e-6
    # the repair ladder ran and replaced the plan
    assert bool(to.pre_hits[:TP.NEAR_TERM_KNOTS].any()) and bool(to.repaired)
    # run_mpc's entry 0 is this plan
    assert torch.equal(results[0].solve.us, to.solve.us)
    # the closure
    f = TP.plan_jit(CFG, spec=TS.analytic_road_spec(dtype=np.float64))
    assert torch.equal(f(scn, START, None, None).solve.us, to.solve.us)


def test_run_mpc_matches_batched_vmap(single):
    scn, spec, results = single
    assert len(results) == 3
    first = results[0].solve
    lane = TP.make_lane_tuple(scn.left_barrier_xy, scn.right_barrier_xy, CFG)
    carry = TM.MpcCarry(xs=first.xs[None], us=first.us[None],
                        cycle_time=torch.zeros(1, dtype=F64))
    scn1 = scn.map(lambda a: a[None])
    for cycle in (1, 2):
        carry, ob = TM.mpc_step_batch(scn1, carry, CFG, lane,
                                      backend="vmap", spec=spec)
        o1 = results[cycle]
        assert torch.equal(ob.solve.us[0], o1.solve.us), cycle
        assert torch.equal(ob.solve.iters[0], o1.solve.iters)
        for f in FLAGS:
            assert bool(getattr(ob, f)[0]) == bool(getattr(o1, f)), (cycle, f)
        assert torch.equal(ob.solve_hits[0], o1.solve_hits)
    # every cycle concluded (a warm-started re-solve at its optimum can end
    # on the regularization cap, the reference's kUnsolved)
    assert all(int(r.solve.status) != SolverStatus.RUNNING for r in results)
    # warm-started cycles need no more iterations than the cold solve,
    # within the JAX package's slack (tests/test_batch_dist.py)
    assert np.mean([int(r.solve.iters) for r in results[1:]]) \
        <= int(first.iters) + 5
    # mpc_scan: the same cycles, stats stacked [C]
    c0 = TM.MpcCarry(xs=first.xs, us=first.us,
                     cycle_time=torch.zeros((), dtype=F64))
    final, st = TM.mpc_scan(scn, c0, CFG, None, lane, 2, spec=spec)
    assert st.iters.tolist() == [int(r.solve.iters) for r in results[1:]]
    assert torch.equal(final.xs, carry.xs[0])
    assert float(final.cycle_time) == pytest.approx(0.2, abs=1e-15)

    # the single-lane repair of the first plan's dirty solve: eligible, it
    # is plan's repair; ineligible, it is neither attempted nor cleared
    norep = dataclasses.replace(CFG, repair=dataclasses.replace(
        CFG.repair, enabled=False))
    raw = TP.plan(scn, START, norep, lane=lane, spec=spec)
    cons = TP.prep_constraints(raw.corridors.map(lambda a: a[None]),
                               CFG).map(lambda a: a[0])
    start6 = TP.start_states(torch.tensor([START], dtype=F64), F64)[0]
    assert bool(raw.still_dirty) and bool(results[0].repaired)
    for el in (True, False):
        r, h, rep = TP._repair_single(
            scn, raw.solve, raw.solve_hits, TP.coarse_to_states(raw.coarse),
            start6, cons, CFG, spec, eligible=torch.tensor(el))
        want = results[0] if el else raw
        assert bool(rep) == el
        assert torch.equal(r.us, want.solve.us)
        assert torch.equal(h, want.solve_hits)


def test_mpc_lane_window_stays_clean():
    """No-fire witness: the standard configuration's 8-cycle blast rollout
    never clips its lane window, and its executed horizon stays clean."""
    cfg = PlannerConfig()
    scns = TS.make_scenario_batch([1, 5], dtype=F64, device="cpu")
    spec = TS.analytic_road_spec(dtype=np.float64)
    starts = torch.tensor(START, dtype=F64).repeat(2, 1)
    out0 = TP.plan_batch(scns, starts, cfg, None, None, spec=spec)
    lane = TP.make_lane_tuple(scns.left_barrier_xy[0],
                              scns.right_barrier_xy[0], cfg)
    carry = TM.MpcCarry(xs=out0.solve.xs, us=out0.solve.us,
                        cycle_time=torch.zeros(2, dtype=F64))
    _, st = TM.mpc_scan_batch(scns, carry, cfg, lane, 8, spec=spec)
    assert st.lane_clipped.shape == (8, 2)
    assert (st.status != SolverStatus.RUNNING).all()
    assert st.corridor_ok.all()
    assert not st.lane_clipped.any(), torch.nonzero(st.lane_clipped)
    assert not st.near_hits.any(), torch.nonzero(st.near_hits)


def test_mpc_lane_clip_guard_fires():
    """Fire witness: a window of 2 segments of 1 m against a ~230 m road
    must clip every cycle, and mpc_scan_batch surfaces it."""
    cfg = PlannerConfig()
    cfg = dataclasses.replace(
        cfg, corridor=dataclasses.replace(cfg.corridor,
                                          lane_segment_length=1.0,
                                          max_lane_segments=256),
        ilqr=dataclasses.replace(cfg.ilqr, lane_window=2))
    scns = TS.make_scenario_batch([1], dtype=F64, device="cpu")
    spec = TS.analytic_road_spec(dtype=np.float64)
    starts = torch.tensor([START], dtype=F64)
    lane = TP.make_lane_tuple(scns.left_barrier_xy[0],
                              scns.right_barrier_xy[0], cfg)
    out0 = TP.plan_batch(scns, starts, cfg, None, lane, spec=spec)
    carry = TM.MpcCarry(xs=out0.solve.xs, us=out0.solve.us,
                        cycle_time=torch.zeros(1, dtype=F64))
    _, st = TM.mpc_scan_batch(scns, carry, cfg, lane, 3, spec=spec)
    assert st.lane_clipped.shape == (3, 1)
    assert st.lane_clipped.all(), st.lane_clipped
