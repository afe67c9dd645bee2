"""The port's DP in every collision mode, and its single-scenario plan
without a RoadSpec, against the JAX package on the CPU in float64.

- ``dp.plan`` in grid mode (the road's BarrierGrid with the dilated table
  for the vehicle radius) and in frenet mode without a RoadSpec (the
  station-field stand-in) on three scenarios, and in exact mode (every
  barrier point) on one scenario with a narrower station and lateral grid
  (NS=4, NL=5; the full grid tests 2.6e9 point-box pairs a scenario),
  each against one jitted and vmapped JAX ``dp.plan``: winning cells and
  ok identical, min cost within 1e-9, coarse trajectories within 1e-9;
- the grid mode's integral-image path (a grid built without ``half``)
  gives the dilated table's winning cells, as in JAX;
- ``pipeline.plan`` without a spec against the JAX package's default call
  ``pipeline.plan(scn, start, cfg)`` (jitted; the compaction cascade off
  and the repair ladder's first round only on both sides, as in
  tests/test_torch_replan.py): ok, dp_ok, repaired, still_dirty and the
  pre-repair hits identical, the coarse trajectory within 1e-9, status and
  iterations identical, controls within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import dp as JD
from cilqr_tpu import pipeline as JP
from cilqr_tpu import scenario as JS
from cilqr_tpu import world as JW
from cilqr_tpu.config import PlannerConfig as JPlannerConfig
from cilqr_tpu_torch import dp as TD
from cilqr_tpu_torch import pipeline as TP
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch import world as TW
from cilqr_tpu_torch.config import PlannerConfig

SEEDS = (0, 1, 156)
F64 = torch.float64
START = (0.0, 0.0, 0.0, 10.0)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _cfgs(**dp):
    c, j = PlannerConfig(), JPlannerConfig()
    return (dataclasses.replace(c, dp=dataclasses.replace(c.dp, **dp)),
            dataclasses.replace(j, dp=dataclasses.replace(j.dp, **dp)))


@pytest.fixture(scope="module")
def scns():
    return (JS.make_scenario_batch(SEEDS, dtype=jnp.float64),
            TS.make_scenario_batch(SEEDS, dtype=F64, device="cpu"))


def _jax_dp(jscn, jcfg, grid):
    f = jax.jit(jax.vmap(lambda s: JD.plan(s, 0.0, 0.0, 0.0, jcfg, grid)))
    return f(jscn)


def _same(got, want):
    np.testing.assert_array_equal(_np(got.sel_s), np.asarray(want.sel_s))
    np.testing.assert_array_equal(_np(got.sel_l), np.asarray(want.sel_l))
    np.testing.assert_array_equal(_np(got.ok), np.asarray(want.ok))
    np.testing.assert_allclose(_np(got.min_cost), np.asarray(want.min_cost),
                               rtol=1e-9, atol=0)
    for f in ("s", "x", "y", "theta", "velocity", "a"):
        np.testing.assert_allclose(_np(getattr(got.traj, f)),
                                   np.asarray(getattr(want.traj, f)),
                                   rtol=0, atol=1e-9, err_msg=f)


def _zeros(n):
    z = torch.zeros(n, dtype=F64)
    return z, z, z


def test_dp_grid_mode_matches_jax(scns):
    jscn, scn = scns
    cfg, jcfg = _cfgs(collision_mode="grid")
    radius = cfg.vehicle.radius
    jgrid = JW.build_barrier_grid(np.asarray(jscn.barrier_xy[0]),
                                  cfg.dp.grid_cell, half=radius)
    grid = TW.build_barrier_grid(scn.barrier_xy[0], cfg.dp.grid_cell,
                                 half=radius, device="cpu")
    got = TD.plan(scn, *_zeros(len(SEEDS)), cfg, grid)
    _same(got, _jax_dp(jscn, jcfg, jgrid))
    # the integral image without the dilated table decides the same
    plain = TW.build_barrier_grid(scn.barrier_xy[0], cfg.dp.grid_cell,
                                  device="cpu")
    got2 = TD.plan(scn, *_zeros(len(SEEDS)), cfg, plain)
    assert torch.equal(got2.sel_s, got.sel_s)
    assert torch.equal(got2.sel_l, got.sel_l)
    with pytest.raises(ValueError, match="BarrierGrid"):
        TD.plan(scn, *_zeros(len(SEEDS)), cfg)


def test_dp_frenet_without_spec_matches_jax(scns):
    jscn, scn = scns
    cfg, jcfg = _cfgs(collision_mode="frenet")
    # a grid passed in frenet mode is ignored, as in JAX
    grid = TW.build_barrier_grid(scn.barrier_xy[0], cfg.dp.grid_cell,
                                 device="cpu")
    got = TD.plan(scn, *_zeros(len(SEEDS)), cfg, grid)
    _same(got, _jax_dp(jscn, jcfg, None))


def test_dp_exact_mode_matches_jax(scns):
    jscn, scn = scns
    cfg, jcfg = _cfgs(collision_mode="exact", ns=4, nl=5)
    got = TD.plan(scn.map(lambda a: a[:1]), *_zeros(1), cfg)
    _same(got, _jax_dp(jax.tree.map(lambda a: a[:1], jscn), jcfg, None))


def test_plan_without_spec_matches_jax_default_call():
    cfg, jcfg = PlannerConfig(), JPlannerConfig()
    cfg = dataclasses.replace(
        cfg, ilqr=dataclasses.replace(cfg.ilqr, compaction_phase1=0),
        repair=dataclasses.replace(cfg.repair,
                                   margins=cfg.repair.margins[:1]))
    jcfg = dataclasses.replace(
        jcfg, ilqr=dataclasses.replace(jcfg.ilqr, compaction_phase1=0),
        repair=dataclasses.replace(jcfg.repair,
                                   margins=jcfg.repair.margins[:1]))
    seed = 2
    jscn = JS.make_scenario(seed, dtype=jnp.float64)
    lane = JP.make_lane_tuple(jscn.left_barrier_xy, jscn.right_barrier_xy,
                              jcfg)
    jo = jax.jit(lambda s: JP.plan(s, START, jcfg, None, lane))(jscn)
    to = TP.plan(TS.make_scenario(seed, dtype=F64, device="cpu"), START, cfg)
    for f in ("dp_ok", "ok", "repaired", "still_dirty"):
        assert bool(getattr(to, f)) == bool(getattr(jo, f)), f
    np.testing.assert_array_equal(_np(to.pre_hits), np.asarray(jo.pre_hits))
    np.testing.assert_array_equal(_np(to.solve_hits),
                                  np.asarray(jo.solve_hits))
    np.testing.assert_allclose(_np(to.coarse.x), np.asarray(jo.coarse.x),
                               rtol=0, atol=1e-9)
    assert int(to.solve.status) == int(jo.solve.status)
    assert int(to.solve.iters) == int(jo.solve.iters)
    assert np.abs(_np(to.solve.us) - np.asarray(jo.solve.us)).max() <= 1e-6


def test_mpc_passes_grid_and_no_spec():
    """run_mpc in grid mode plans through the road's grid (its initial
    plan is pipeline.plan with that grid, bit for bit), and a cycle of
    mpc_step_batch and mpc_scan_batch without a spec re-checks every
    barrier point at the cycle's time (exact mode)."""
    from cilqr_tpu_torch import mpc as TM

    cfg, _ = _cfgs(collision_mode="grid")
    scn = TS.make_scenario(2, dtype=F64, device="cpu")
    res = TM.run_mpc(scn, START, cfg, 1)
    want = TP.plan(scn, START, cfg, TP.road_grid(scn.barrier_xy, cfg))
    assert torch.equal(res[0].solve.us, want.solve.us)
    assert int(res[1].solve.status) != 0 and bool(res[1].corridor_ok)

    scn1 = scn.map(lambda a: a[None])
    lane = TP.make_lane_tuple(scn.left_barrier_xy, scn.right_barrier_xy, cfg)
    carry = TM.MpcCarry(xs=want.solve.xs[None], us=want.solve.us[None],
                        cycle_time=torch.zeros(1, dtype=F64))
    c1, out = TM.mpc_step_batch(scn1, carry, cfg, lane, backend="vmap")
    hits = TP._recheck_solution(scn1, out.solve.xs, cfg, None,
                                t0=c1.cycle_time)
    assert torch.equal(out.solve_hits, hits)
    c2, st = TM.mpc_scan_batch(scn1, carry, cfg, lane, 1, backend="vmap")
    assert torch.equal(c2.xs, c1.xs) and st.status.shape == (1, 1)
