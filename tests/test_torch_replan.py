"""The port's full replan (pipeline.plan_batch and the modules under it)
against the JAX package, float64 on the CPU, on the same inputs.

The port's replan of seeds 0, 1, 2 and 156 (its solves without the
compaction cascade, the repair ladder's first round only) is shared by the
module; seed 156's static-vehicle
graze re-checks dirty in the near-term horizon in float64 too, so the
repair ladder runs. One test runs JAX's ``plan_batch`` on the same seeds,
jitted, with its DP's winning cells beside it; the other modules are held
to JAX's functions on the port's replan, op by op. The tolerances:

- scenarios and RoadSpec: bit-identical (both draw from the same seeded
  numpy generator in the same order);
- reference-line fields, dynamic obstacles at query times, road-barrier
  and collision probes, convex hulls (counts, indices, payloads):
  identical (both run the same operations in the same order), except
  values through a square root (hypot, the projection's lateral) within 2
  ulp (PyTorch's vectorized CPU square root is not correctly rounded, and
  XLA fuses 1 + r*r of jnp.hypot into one multiply-add), the path profile
  (second differences over dt of them) within 1e-9 and get_cartesian
  (through sin and cos) within 1e-12;
- DP winning cells identical, coarse trajectories within 1e-9;
- corridors along the port's coarse trajectories, against JAX's
  plan_corridors run op by op (inside a jit XLA fuses multiply-adds, which
  moves near-degenerate hull decisions): ok and masks identical, planes
  and polygons within 1e-9 scaled by 1 + |value|;
- total_cost within 1e-9 relative;
- plan_batch lane for lane: ok, pre-repair and final near-term hits,
  repaired, still_dirty identical; status and iterations identical on at
  least 3 of the 4 lanes, controls within 1e-6 on those;
- the ladder's cold round alone (JAX's _repair_batch, jitted, from the
  port's pre-repair state): the same write-back, re-check and statuses;
- the port's replan with the compaction cascade against the shared one
  without it: the same safety flags, decisions on at least 3 of 4 lanes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import corridor as JC
from cilqr_tpu import costs as JCo
from cilqr_tpu import dp as JD
from cilqr_tpu import geometry as JG
from cilqr_tpu import pipeline as JP
from cilqr_tpu import reference_line as JR
from cilqr_tpu import scenario as JS
from cilqr_tpu import types as JT
from cilqr_tpu import world as JW
from cilqr_tpu.config import PlannerConfig as JPlannerConfig
from cilqr_tpu.types import Traj as JTraj
from cilqr_tpu_torch import convert
from cilqr_tpu_torch import corridor as TC
from cilqr_tpu_torch import costs as TCo
from cilqr_tpu_torch import dp as TD
from cilqr_tpu_torch import geometry as TG
from cilqr_tpu_torch import pipeline as TP
from cilqr_tpu_torch import reference_line as TR
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch import world as TW
from cilqr_tpu_torch.config import PlannerConfig
from cilqr_tpu_torch.solver import iqr_init, transform_goals

import torch_shared

SEEDS = torch_shared.SEEDS
DIRTY_SEED = 156
# the solves without the compaction cascade (tests/test_torch_solve.py
# holds it), and a ladder of its first (warm) round only: JAX compiles its
# solve once per cascade width and per round's configuration, which would
# take most of this module's time (test_repair_rounds_match_jax holds the
# rounds' configurations)
CFG = torch_shared.replan_config()
JCFG = JPlannerConfig()
JCFG = dataclasses.replace(
    JCFG, ilqr=dataclasses.replace(JCFG.ilqr, compaction_phase1=0),
    repair=dataclasses.replace(JCFG.repair, margins=JCFG.repair.margins[:1]))
F64 = torch.float64
NEAR = TP.NEAR_TERM_KNOTS


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.fixture(scope="module")
def jscn():
    return JS.make_scenario_batch(SEEDS, dtype=jnp.float64)


@pytest.fixture(scope="module")
def scn():
    return TS.make_scenario_batch(SEEDS, dtype=F64, device="cpu")


@pytest.fixture(scope="module")
def lane(jscn):
    return JP.make_lane_tuple(jscn.left_barrier_xy[0],
                              jscn.right_barrier_xy[0], JCFG)


@pytest.fixture(scope="module")
def port_dp(scn, lane):
    """The port's DP and corridors on SEEDS (the replan's first stages)."""
    spec = TS.analytic_road_spec(dtype=np.float64)
    z = torch.zeros(len(SEEDS), dtype=F64)
    d = TD.plan(scn, z, z, z, CFG, spec=spec)
    return d, TC.plan_corridors(scn, d.traj, CFG.corridor, lane)


@pytest.fixture(scope="module")
def port_plan(request, tmp_path_factory):
    """The port's plan_batch on SEEDS in CFG, with the road's lane
    constraints and RoadSpec (computed once a test run: torch_shared)."""
    return torch_shared.replan(request, tmp_path_factory)


def test_scenarios_bit_identical(jscn, scn):
    got = convert.scenario_to_numpy(scn)
    for name, want in convert.scenario_to_numpy(
            convert.scenario_from_numpy(jscn, F64, "cpu")).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
        assert got[name].dtype == want.dtype, name
    # float32: both round the same float64 arrays
    s32 = TS.make_scenario_batch(SEEDS[:2], dtype=torch.float32, device="cpu")
    j32 = JS.make_scenario_batch(SEEDS[:2], dtype=jnp.float32)
    for name in ("static_obs", "dyn_obs", "dyn_times", "barrier_xy",
                 "right_barrier_xy"):
        np.testing.assert_array_equal(_np(getattr(s32, name)),
                                      np.asarray(getattr(j32, name)))
    for dt in (np.float64, np.float32):
        js, ts = JS.analytic_road_spec(dtype=dt), TS.analytic_road_spec(
            dtype=dt)
        via = convert.road_spec_from_numpy(js)
        for f in ("row_start", "count", "is_arc", "xc", "yc", "ang0", "dang",
                  "yaw0", "yaw_inc", "kappa", "x0", "y0", "stepx", "stepy",
                  "h", "lb", "rb", "kappa0"):
            np.testing.assert_array_equal(getattr(ts, f), np.asarray(
                getattr(js, f)), err_msg=f)
            np.testing.assert_array_equal(getattr(via, f), getattr(ts, f))
        assert ts.n == js.n == via.n


def test_reference_line_matches_jax(jscn, scn):
    rng = np.random.default_rng(3)
    q = rng.uniform(-5.0, 200.0, (2, 300))
    q[:, :40] = np.round(q[:, :40], 1)          # on and near the grid
    qt = torch.tensor(q)
    cl = scn.centerline.map(lambda a: a[:2])
    spec_t = TS.analytic_road_spec(dtype=np.float64)
    spec_j = JS.analytic_road_spec(dtype=np.float64)
    packed = TR.pack_station_rows(cl)
    for b in range(2):
        jcl = jax.tree.map(lambda a: a[b], jscn.centerline)
        qj = jnp.asarray(q[b])
        want = JR.evaluate_station(jcl, qj)
        got = TR.evaluate_station(cl, qt)
        for f in TR.TRAJ_FIELDS:
            np.testing.assert_array_equal(_np(getattr(got, f))[b],
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        # a time table: the stations, 0.1 s a metre
        want = JR.evaluate_time(jcl.replace(time=jcl.s * 0.1), qj * 0.1)
        got = TR.evaluate_time(dataclasses.replace(cl, time=cl.s * 0.1),
                               qt * 0.1)
        for f in TR.TRAJ_FIELDS:
            np.testing.assert_array_equal(_np(getattr(got, f))[b],
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        for pk in (None, packed):
            got = TR.evaluate_station_fields(cl, qt, packed=pk)
            want = JR.evaluate_station_fields(
                jcl, qj, packed=None if pk is None else
                JR.pack_station_rows(jcl))
            for f in TR.DP_FIELDS:
                np.testing.assert_array_equal(_np(got[f])[b],
                                              np.asarray(want[f]), err_msg=f)
        got = TR.evaluate_station_fields_analytic(spec_t, qt)
        want = JR.evaluate_station_fields_analytic(spec_j, qj)
        for f in TR.DP_FIELDS:
            np.testing.assert_array_equal(_np(got[f])[b],
                                          np.asarray(want[f]), err_msg=f)
        px, py = rng.uniform(-10, 60, (2, 50))
        s_j, l_j, _ = JR.get_projection(jcl, jnp.asarray(px),
                                        jnp.asarray(py))
        s_t, l_t, _ = TR.get_projection(
            cl.map(lambda a: a[b:b + 1]), torch.tensor(px)[None],
            torch.tensor(py)[None])
        np.testing.assert_array_equal(_np(s_t)[0], np.asarray(s_j))
        np.testing.assert_array_max_ulp(_np(l_t)[0], np.asarray(l_j), 2)
        lat = rng.uniform(-6, 3, 300)
        got = TR.get_cartesian(cl, qt, torch.tensor(lat).expand(2, -1))
        want = JR.get_cartesian(jcl, qj, jnp.asarray(lat))
        for g_, w_ in zip(got, want):      # through sin and cos
            np.testing.assert_allclose(_np(g_)[b], np.asarray(w_), rtol=0,
                                       atol=1e-12)
    xs = np.cumsum(rng.uniform(0.0, 1.0, (2, 81)), -1)
    xs[:, 5] = xs[:, 4]                          # a zero-length segment
    ys = np.sin(xs / 7.0)
    got = TR.compute_path_profile(0.1, torch.tensor(xs), torch.tensor(ys))
    for b in range(2):
        want = JR.compute_path_profile(0.1, jnp.asarray(xs[b]),
                                       jnp.asarray(ys[b]))
        # through square roots, then differences of differences over dt
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(_np(g_)[b], np.asarray(w_), rtol=1e-9,
                                       atol=1e-9)


def test_world_probes_match_jax(jscn, scn):
    """dyn_polys_at, the dynamic corner query, barrier_hit_road_spec and
    check_optimization_collision (frenet with the RoadSpec, and exact)
    identical, on random poses near the road and its obstacles."""
    rng = np.random.default_rng(5)
    spec_t = TS.analytic_road_spec(dtype=np.float64)
    spec_j = JS.analytic_road_spec(dtype=np.float64)
    times = np.round(rng.uniform(0.0, 9.0, (len(SEEDS), 40)), 2)
    times[:, :5] = [0.0, 0.1, 4.0, 8.0, 16.05]
    tt = torch.tensor(times)
    polys, active = TW.dyn_polys_at(scn, tt)
    pts, pmask = TW.query_dynamic_points_grid(scn, tt)
    # poses around the obstacles' corners and the road boundaries
    cx = np.concatenate([
        _np(scn.dyn_obs[:, :, ::23, 0, 0]).reshape(len(SEEDS), -1)[:, :20],
        rng.uniform(0.0, 60.0, (len(SEEDS), 20))], 1)
    cy = np.concatenate([
        _np(scn.dyn_obs[:, :, ::23, 0, 1]).reshape(len(SEEDS), -1)[:, :20],
        rng.uniform(-10.0, 30.0, (len(SEEDS), 20))], 1)
    cx += rng.normal(0.0, 1.0, cx.shape)
    cy += rng.normal(0.0, 1.0, cy.shape)
    th = rng.uniform(-np.pi, np.pi, cx.shape)
    hit_spec = TW.barrier_hit_road_spec(1.2, torch.tensor(cx),
                                        torch.tensor(cy), spec_t)
    dyn = (polys, active)
    args = (torch.tensor(cx), torch.tensor(cy), torch.tensor(th),
            CFG.vehicle.radius, CFG.vehicle.r2x, CFG.vehicle.f2x)
    col_f = TW.check_optimization_collision(scn, *args, mode="frenet",
                                            road_spec=spec_t, dyn_polys=dyn)
    col_e = TW.check_optimization_collision(scn, *args, mode="exact",
                                            dyn_polys=dyn)
    n_hits = 0
    for b in range(len(SEEDS)):
        s1 = jax.tree.map(lambda a: a[b], jscn)
        jd = JW.dyn_polys_at(s1, jnp.asarray(times[b]))
        np.testing.assert_array_equal(_np(polys[b]), np.asarray(jd[0]))
        np.testing.assert_array_equal(_np(active[b]), np.asarray(jd[1]))
        jq = JW.query_dynamic_points_grid(s1, jnp.asarray(times[b]))
        np.testing.assert_array_equal(_np(pts[b]), np.asarray(jq[0]))
        np.testing.assert_array_equal(_np(pmask[b]), np.asarray(jq[1]))
        np.testing.assert_array_equal(_np(hit_spec[b]), np.asarray(
            JW.barrier_hit_road_spec(1.2, jnp.asarray(cx[b]),
                                     jnp.asarray(cy[b]), spec_j)))
        # probes at query times: the trailing axis is the time axis
        for mode, got in (("frenet", col_f), ("exact", col_e)):
            want = JW.check_optimization_collision(
                s1, None, jnp.asarray(cx[b]), jnp.asarray(cy[b]),
                jnp.asarray(th[b]), CFG.vehicle.radius, CFG.vehicle.r2x,
                CFG.vehicle.f2x, grid=None, mode=mode,
                road_spec=spec_j if mode == "frenet" else None,
                dyn_polys=jd)
            np.testing.assert_array_equal(_np(got[b]), np.asarray(want),
                                          err_msg=mode)
            n_hits += int(np.asarray(want).sum())
    assert n_hits > 0 and int(active.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_convex_hull_matches_jax(seed):
    """Random point sets on a half-metre grid (duplicates, collinear runs,
    -0.0 beside +0.0) with random masks: counts, vertices, indices and
    payload identical."""
    rng = np.random.default_rng(seed)
    pts = np.round(rng.normal(size=(64, 24, 2)) * 3) / 2
    pts[:8, :, 1] = 0.0                            # all collinear
    pts[8:16, :12] = pts[8:16, 12:]                # duplicates
    mask = rng.random((64, 24)) > 0.25
    mask[16] = False
    mask[17, 1:] = False                           # a single point
    pay = rng.normal(size=(64, 24))
    want = jax.vmap(lambda p, m, y: JG.convex_hull_masked(
        p, m, return_indices=True, payload=(y,)))(
            jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pay))
    got = TG.convex_hull_masked(torch.tensor(pts), torch.tensor(mask),
                                return_indices=True,
                                payload=(torch.tensor(pay),))
    for g_, w_ in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(_np(g_), np.asarray(w_))
    np.testing.assert_array_equal(_np(got[4][0]), np.asarray(want[4][0]))
    assert {0, 1} <= set(_np(got[2]).tolist())


def test_hypot_matches_jax():
    rng = np.random.default_rng(7)
    a = np.concatenate([rng.normal(size=1000) * 10.0 ** rng.integers(
        -8, 8, 1000), [0.0, -0.0, np.inf, 3.0, 0.0]])
    b = np.concatenate([rng.normal(size=1000), [0.0, 2.0, 1.0, -np.inf,
                                                -0.0]])
    for dt in (np.float64, np.float32):
        got = _np(TG.hypot(torch.tensor(a.astype(dt)),
                           torch.tensor(b.astype(dt))))
        want = np.asarray(jnp.hypot(jnp.asarray(a, dt), jnp.asarray(b, dt)))
        np.testing.assert_array_max_ulp(got, want, 2)
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))


def test_geometry_matches_jax():
    """The convex-polygon primitives: SAT overlaps (box against polygon,
    polygon against polygon), point membership, oriented box corners,
    rotation and interpolation, on random boxes and points near them."""
    rng = np.random.default_rng(11)
    n = 200
    c = rng.uniform(-5, 5, (n, 2))
    th = rng.uniform(-np.pi, np.pi, n)
    le, wi = 4.0, 2.0
    boxes_t = TG.box_corners(torch.tensor(c[:, 0]), torch.tensor(c[:, 1]),
                             torch.tensor(th), le, wi)
    boxes_j = JG.box_corners(jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]),
                             jnp.asarray(th), le, wi)
    np.testing.assert_array_max_ulp(_np(boxes_t), np.asarray(boxes_j), 2)
    boxes = np.asarray(boxes_j)
    mask = rng.random((n, 4)) > 0.1
    other = boxes[::-1].copy() * 0.7
    m2 = mask[::-1].copy()
    bt, ot = torch.tensor(boxes), torch.tensor(other)
    np.testing.assert_array_equal(
        _np(TG.convex_overlap(bt, torch.tensor(mask), ot, torch.tensor(m2))),
        np.asarray(jax.vmap(JG.convex_overlap)(boxes, mask, other, m2)))
    lo = rng.uniform(-6, 4, (n, 2))
    hi = lo + rng.uniform(0.1, 3, (n, 2))
    np.testing.assert_array_equal(
        _np(TG.convex_overlap_aabb(bt, torch.tensor(mask),
                                   *(torch.tensor(v) for v in (
                                       lo[:, 0], lo[:, 1], hi[:, 0],
                                       hi[:, 1])))),
        np.asarray(jax.vmap(JG.convex_overlap_aabb)(
            boxes, mask, lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1])))
    p = rng.uniform(-6, 6, (n, 2))
    np.testing.assert_array_equal(
        _np(TG.point_in_convex_polygon(torch.tensor(p[:, 0]),
                                       torch.tensor(p[:, 1]), bt,
                                       torch.tensor(mask))),
        np.asarray(jax.vmap(JG.point_in_convex_polygon)(
            p[:, 0], p[:, 1], boxes, mask)))
    x, y, t = (rng.normal(size=n) for _ in range(3))
    for g_, w_ in zip(TG.rot(torch.tensor(x), torch.tensor(y),
                             torch.tensor(t)),
                      JG.rot(jnp.asarray(x), jnp.asarray(y), jnp.asarray(t))):
        np.testing.assert_array_max_ulp(_np(g_), np.asarray(w_), 4)
    a0, a1, t0, t1, tq = (rng.normal(size=n) * 3 for _ in range(5))
    t1[:10] = t0[:10]                              # zero-length spans
    args = [a0, t0, a1, t1, tq]
    for tf, jf in ((TG.lerp, JG.lerp), (TG.slerp, JG.slerp)):
        np.testing.assert_array_equal(
            _np(tf(*(torch.tensor(v) for v in args))),
            np.asarray(jf(*(jnp.asarray(v) for v in args))))


def test_traj_and_dynamic_points_match_jax(jscn, scn):
    """traj_from_solution on random trajectories, and the per-time dynamic
    corner query, against the JAX functions."""
    rng = np.random.default_rng(13)
    xs = np.cumsum(rng.normal(size=(3, 81, 6)) * 0.1, axis=1)
    us = rng.normal(size=(3, 80, 2))
    got = TP.traj_from_solution(torch.tensor(xs), torch.tensor(us),
                                CFG.delta_t, CFG.vehicle.wheel_base)
    want = jax.vmap(lambda x, u: JP.traj_from_solution(
        x, u, JCFG.delta_t, JCFG.vehicle.wheel_base))(jnp.asarray(xs),
                                                      jnp.asarray(us))
    for f in TR.TRAJ_FIELDS:          # s through square roots
        np.testing.assert_allclose(_np(getattr(got, f)), np.asarray(
            getattr(want, f)), rtol=1e-12, atol=1e-12, err_msg=f)
    times = np.asarray([0.0, 0.35, 3.0, 7.9])
    pts, mask = TW.query_dynamic_points(scn, torch.tensor(times))
    for b in range(len(SEEDS)):
        wp, wm = JW.query_dynamic_points(jax.tree.map(lambda a: a[b], jscn),
                                         jnp.asarray(times[b]))
        np.testing.assert_array_equal(_np(pts[b]), np.asarray(wp))
        np.testing.assert_array_equal(_np(mask[b]), np.asarray(wm))


def test_dp_scenario_chunks(scn, port_dp):
    """The DP splits its scenarios into chunks by a probe budget: one
    scenario a chunk decides and interpolates as the whole batch does."""
    spec = TS.analytic_road_spec(dtype=np.float64)
    z = torch.zeros(len(SEEDS), dtype=F64)
    old = TD.PROBES_PER_CHUNK
    try:
        TD.PROBES_PER_CHUNK = 70 * 70 * 16
        chunked = TD.plan(scn, z, z, z, CFG, spec=spec)
    finally:
        TD.PROBES_PER_CHUNK = old
    whole = port_dp[0]
    for f in ("s", "x", "y", "theta", "velocity", "a", "delta"):
        assert torch.equal(getattr(chunked.traj, f),
                           getattr(whole.traj, f)), f
    assert torch.equal(chunked.sel_s, whole.sel_s)
    assert torch.equal(chunked.ok, whole.ok)


def test_corridors_match_jax(scn, jscn, lane, port_dp):
    coarse = port_dp[0].traj
    jtraj = JTraj(**{f: jnp.asarray(_np(getattr(coarse, f)))
                     for f in TR.TRAJ_FIELDS})
    jc = jax.vmap(lambda s, tr: JC.plan_corridors(s, tr, JCFG.corridor,
                                                  lane))(jscn, jtraj)
    old = TC.PAIRS_PER_CHUNK
    try:
        TC.PAIRS_PER_CHUNK = 81 * 97 * 97 * 3     # chunks of 3 scenarios
        got = TC.plan_corridors(scn, coarse, CFG.corridor, lane)
    finally:
        TC.PAIRS_PER_CHUNK = old
    np.testing.assert_array_equal(_np(got.ok), np.asarray(jc.ok))
    np.testing.assert_array_equal(_np(got.plane_mask),
                                  np.asarray(jc.plane_mask))
    np.testing.assert_array_equal(_np(got.poly_mask),
                                  np.asarray(jc.poly_mask))
    for f in ("planes", "polygons", "left_planes", "left_segs",
              "right_planes", "right_segs"):
        w_ = np.asarray(getattr(jc, f))
        err = np.abs(_np(getattr(got, f)) - w_) / (1.0 + np.abs(w_))
        assert err.max() <= 1e-9, (f, err.max())
    assert bool(np.asarray(jc.ok).all())
    # unchunked, the same corridors
    assert torch.equal(got.planes, port_dp[1].planes)


def test_total_cost_matches_jax(port_dp):
    """total_cost of the replan's LQR initial guesses against its
    production constraints (untrimmed, and trimmed: the same cost)."""
    d, c = port_dp
    cons = TCo.shrink_and_normalize(
        c.planes, c.plane_mask, c.left_planes, c.left_segs, c.left_mask,
        c.right_planes, c.right_segs, c.right_mask, CFG.ilqr, CFG.vehicle)
    starts = TP.start_states(torch.tensor([[0.0, 0.0, 0.0, 10.0]] * len(
        SEEDS), dtype=F64), F64)
    goals = transform_goals(TP.coarse_to_states(d.traj), starts)
    xs, us = iqr_init(goals, CFG.ilqr, CFG.vehicle, CFG.delta_t)
    got = TCo.total_cost(xs, us, goals, cons, CFG.ilqr, CFG.vehicle)
    jcons = JCo.ConstraintSet(*(jnp.asarray(_np(v)) for v in cons))
    # jitted: one compile (its fused multiply-adds move the sums' last
    # bits, far inside the tolerance)
    want = jax.jit(jax.vmap(lambda x, u, g, k: JCo.total_cost(
        x, u, g, k, JCFG.ilqr, JCFG.vehicle)))(
            jnp.asarray(_np(xs)), jnp.asarray(_np(us)),
            jnp.asarray(_np(goals)), jcons)
    for f in ("total", "target", "dynamic", "corridor", "lane"):
        np.testing.assert_allclose(_np(getattr(got, f)), np.asarray(
            getattr(want, f)), rtol=1e-9, atol=1e-9, err_msg=f)
    trimmed = TCo.total_cost(xs, us, goals, TCo.trim_constraints(cons),
                             CFG.ilqr, CFG.vehicle)
    np.testing.assert_allclose(_np(trimmed.total), _np(got.total),
                               rtol=1e-12)


def test_brake_goals():
    """Equal to JAX's, and what it should do: pose and steer unchanged at
    knot 0 (v and a are scaled at every knot), every knot on the original
    polyline at gamma of its arc length measured ALONG that polyline."""
    t = np.arange(81) * 0.1
    g = np.zeros((2, 81, 6))
    g[:, :, 0] = 30 * np.sin(0.3 * t)
    g[:, :, 1] = 30 * (1 - np.cos(0.3 * t))
    g[:, :, 2] = 0.3 * t
    g[:, :, 3] = 9.0 - 0.02 * np.arange(81)
    g[:, :, 4] = -0.2
    g[:, :, 5] = 0.05
    g[1, :, 0] = np.arange(81) * 0.8               # a straight, and a stall
    g[1, :, 1] = 0.0
    g[1, 40:45, 0] = g[1, 40, 0]
    gamma = 0.6
    got = _np(TP.brake_goals(torch.tensor(g), gamma))
    for b in range(2):
        np.testing.assert_allclose(got[b], np.asarray(JP.brake_goals(
            jnp.asarray(g[b]), gamma)), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got[b, 0, [0, 1, 2, 5]],
                                      g[b, 0, [0, 1, 2, 5]])
        assert got[b, 0, 3] == pytest.approx(gamma * g[b, 0, 3], abs=1e-12)
        # arc length along the ORIGINAL polyline, by projecting each braked
        # knot onto its segment
        seg = np.hypot(np.diff(g[b, :, 0]), np.diff(g[b, :, 1]))
        s = np.concatenate([[0.0], np.cumsum(seg)])
        d = TG.point_segment_distance(
            torch.tensor(got[b, :, 0:1]), torch.tensor(got[b, :, 1:2]),
            torch.tensor(g[b, :-1, 0][None]), torch.tensor(g[b, :-1, 1][None]),
            torch.tensor(g[b, 1:, 0][None]), torch.tensor(g[b, 1:, 1][None]))
        k = _np(d.argmin(dim=1))
        assert float(_np(d.min(dim=1).values).max()) < 1e-9
        along = s[k] + np.hypot(got[b, :, 0] - g[b, k, 0],
                                got[b, :, 1] - g[b, k, 1])
        np.testing.assert_allclose(along, gamma * s, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[:, :, 4], gamma ** 2 * -0.2, atol=1e-12)


def test_plan_batch_matches_jax(jscn, lane, port_dp, port_plan):
    """JAX's plan_batch on SEEDS (one jit, its DP's winning cells beside
    it) against the port's, lane for lane."""
    spec = JS.analytic_road_spec(dtype=np.float64)
    starts = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 10.0]), (len(SEEDS), 1))

    def run(scns, st):
        d = jax.vmap(lambda s, x: JD.plan(s, x[0], x[1], x[2], JCFG, None,
                                          spec=spec))(scns, st)
        return (JP.plan_batch(scns, st, JCFG, None, lane, spec=spec),
                d.sel_s, d.sel_l)

    jo, sel_s, sel_l = jax.jit(run)(jscn, starts)
    to = port_plan

    # DP: winning cells identical, coarse trajectories to round-off
    d = port_dp[0]
    np.testing.assert_array_equal(_np(d.sel_s), np.asarray(sel_s))
    np.testing.assert_array_equal(_np(d.sel_l), np.asarray(sel_l))
    for f in ("s", "x", "y", "theta", "kappa", "velocity", "a", "delta",
              "left_bound", "right_bound"):
        np.testing.assert_allclose(_np(getattr(to.coarse, f)),
                                   np.asarray(getattr(jo.coarse, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_array_equal(_np(to.dp_ok), np.asarray(jo.dp_ok))

    np.testing.assert_array_equal(_np(to.ok), np.asarray(jo.ok))
    np.testing.assert_array_equal(_np(to.pre_hits), np.asarray(jo.pre_hits))
    np.testing.assert_array_equal(_np(to.solve_hits)[:, :NEAR],
                                  np.asarray(jo.solve_hits)[:, :NEAR])
    np.testing.assert_array_equal(_np(to.repaired), np.asarray(jo.repaired))
    np.testing.assert_array_equal(_np(to.still_dirty),
                                  np.asarray(jo.still_dirty))
    # the repair ladder ran: the dirty seed's lane was repaired
    dirty = np.asarray(jo.pre_hits)[:, :NEAR].any(1)
    assert dirty.tolist() == [s == DIRTY_SEED for s in SEEDS]
    assert _np(to.repaired).tolist() == dirty.tolist()
    st_j, it_j = np.asarray(jo.solve.status), np.asarray(jo.solve.iters)
    assert np.isin(_np(to.solve.status), (1, 2, 3)).all()
    same = (_np(to.solve.status) == st_j) & (_np(to.solve.iters) == it_j)
    assert same.sum() >= 3, (same, _np(to.solve.iters), it_j)
    du = np.abs(_np(to.solve.us) - np.asarray(jo.solve.us)).max(axis=(1, 2))
    assert du[same].max() <= 1e-6, du
    # the port's final cost of a repaired lane is total_cost of its
    # trajectory against the production constraints
    cons = TP.prep_constraints(to.corridors, CFG)
    goals = transform_goals(TP.coarse_to_states(to.coarse),
                            to.solve.xs[:, 0])
    want = TCo.total_cost(to.solve.xs, to.solve.us, goals, cons, CFG.ilqr,
                          CFG.vehicle)
    np.testing.assert_allclose(_np(to.solve.cost.total)[dirty],
                               _np(want.total)[dirty], rtol=1e-12)


def test_repair_writes_back_first_occurrences(scn, port_plan, monkeypatch):
    """The repair gathers R lanes, its dirty lanes padded with cyclic
    copies; it writes back only each lane's first occurrence. A solve that
    makes the copies differ shows it: the copies' results are dropped."""
    calls = []
    real = TP.solve_batch

    def solve_batch(goals, starts, cons, *a, **k):
        res = real(goals, starts, cons, *a, **k)
        calls.append(goals.shape[0])
        # poison every copy (positions >= 1: one dirty lane)
        res.xs[1:] = float("nan")
        res.status[1:] = 4
        return res

    monkeypatch.setattr(TP, "solve_batch", solve_batch)
    pre = port_plan.pre_hits
    res, hits, repaired, still = TP._repair_batch(
        scn, port_plan.solve, pre, TP.coarse_to_states(port_plan.coarse),
        TP.start_states(torch.tensor([[0.0, 0.0, 0.0, 10.0]] * len(SEEDS),
                                     dtype=F64), F64),
        TP.prep_constraints(port_plan.corridors, CFG), CFG,
        TS.analytic_road_spec(dtype=np.float64))
    assert calls and all(n == TP.repair_width(len(SEEDS), 0.125)
                         for n in calls)
    assert torch.isfinite(res.xs).all()
    assert repaired.tolist() == port_plan.repaired.tolist()
    assert not still.any()


def _same_safety(got, want):
    """ok, pre-repair and final near-term hits, repaired and still dirty
    identical lane for lane."""
    for f in ("ok", "repaired", "still_dirty"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)), err_msg=f)
    for f in ("pre_hits", "solve_hits"):
        np.testing.assert_array_equal(_np(getattr(got, f))[:, :NEAR],
                                      _np(getattr(want, f))[:, :NEAR],
                                      err_msg=f)


def test_cold_repair_round_matches_jax(jscn, scn, port_dp):
    """The ladder's cold round (margin 1.0 from the LQR guess, at the cold
    stop tolerances and iteration cap: the default ladder's round 1, 70%
    of a blast replan on the card) on DIRTY_SEED's lane, the port's
    _repair_batch against JAX's, the one plan_batch calls, from the same
    pre-repair state (the port's DP, corridors, main solve and re-check on
    SEEDS). At the default ladder the warm round repairs that lane and the
    cold round never runs, so the ladder here is the cold round alone;
    jitted, JAX compiles that round's solve and nothing else. At the
    cold tolerance the rel-cost stop is threshold-chaotic (its iteration
    count moves under a 1e-12 change of the lane's goals), so the repaired
    lane's iterations and controls are not held; its status, the
    write-back and the re-check are, and the other lanes' solves."""
    kw = dict(margins=JPlannerConfig().repair.margins[1:2],
              cold_restart_from=0)
    cfg = dataclasses.replace(CFG, repair=dataclasses.replace(CFG.repair,
                                                              **kw))
    jcfg = dataclasses.replace(JCFG, repair=dataclasses.replace(JCFG.repair,
                                                                **kw))
    assert TP._repair_rounds(cfg.repair) == [(1.0, False, 1.0)]
    d, c = port_dp
    spec = TS.analytic_road_spec(dtype=np.float64)
    cons = TP.prep_constraints(c, CFG)
    goals = TP.coarse_to_states(d.traj)
    s6 = TP.start_states(torch.tensor([[0.0, 0.0, 0.0, 10.0]] * len(SEEDS),
                                      dtype=F64), F64)
    res = TP.solve_batch(goals, s6, cons, CFG.ilqr, CFG.vehicle, CFG.delta_t)
    hits = TP._recheck_solution(scn, res.xs, CFG, spec)
    dirty = [s == DIRTY_SEED for s in SEEDS]
    assert _np(hits[:, :NEAR].any(-1)).tolist() == dirty
    got, got_hits, got_rep, got_still = TP._repair_batch(
        scn, res, hits, goals, s6, cons, cfg, spec)

    def j(v):
        return jnp.asarray(_np(v))

    jres = JT.SolveResult(
        xs=j(res.xs), us=j(res.us), status=j(res.status), iters=j(res.iters),
        cost=JT.CostBreakdown(*(j(v) for v in (
            res.cost.total, res.cost.target, res.cost.dynamic,
            res.cost.corridor, res.cost.lane))),
        lam=j(res.lam), init_xs=j(res.init_xs), init_us=j(res.init_us),
        lane_clipped=j(res.lane_clipped))
    jspec = JS.analytic_road_spec(dtype=np.float64)
    want, want_hits, want_rep, want_still = jax.jit(
        lambda r, h, g, s, k: JP._repair_batch(jscn, r, h, g, s, k, jcfg,
                                               jspec))(
        jres, j(hits), j(goals), j(s6), JCo.ConstraintSet(*map(j, cons)))
    np.testing.assert_array_equal(_np(got_rep), np.asarray(want_rep))
    np.testing.assert_array_equal(_np(got_still), np.asarray(want_still))
    np.testing.assert_array_equal(_np(got_hits)[:, :NEAR],
                                  np.asarray(want_hits)[:, :NEAR])
    assert _np(got_rep).tolist() == dirty and not got_still.any()
    # the repaired lane's status; the others untouched, as in JAX
    st_j, it_j = np.asarray(want.status), np.asarray(want.iters)
    np.testing.assert_array_equal(_np(got.status), st_j)
    same = _np(got.iters) == it_j
    assert same.sum() >= 3, (_np(got.iters), it_j)
    du = np.abs(_np(got.us) - np.asarray(want.us)).max(axis=(1, 2))
    assert du[same].max() <= 1e-6, du


def test_cascade_keeps_the_replan_safety(scn, port_plan):
    """The replan with the compaction cascade on (compaction_phase1=3, the
    default) against the shared replan without it: the same safety flags
    lane for lane, decisions on at least 3 of the 4 lanes. No JAX."""
    cfg = dataclasses.replace(CFG, ilqr=dataclasses.replace(
        CFG.ilqr, compaction_phase1=PlannerConfig().ilqr.compaction_phase1))
    assert cfg.ilqr.compaction_phase1 == 3
    lane = TP.make_lane_tuple(scn.left_barrier_xy[0], scn.right_barrier_xy[0],
                              cfg)
    starts = torch.tensor([[0.0, 0.0, 0.0, 10.0]] * len(SEEDS), dtype=F64)
    got = TP.plan_batch(scn, starts, cfg, None, lane,
                        spec=TS.analytic_road_spec(dtype=np.float64))
    _same_safety(got, port_plan)
    same = ((got.solve.status == port_plan.solve.status)
            & (got.solve.iters == port_plan.solve.iters))
    assert int(same.sum()) >= 3, (same, got.solve.iters,
                                  port_plan.solve.iters)


@pytest.mark.parametrize("margins, cold_from, brake",
                         [((1.0, 1.0), 1, 0.0), ((0.5, 1.0, 1.5), 2, 0.6),
                          ((), 1, 0.6), ((1.0,), 0, 1.0)])
def test_repair_rounds_match_jax(margins, cold_from, brake):
    """The ladder's rounds (margin, warm, gamma), each round's solver
    configuration (cold rounds at the tightened stop tolerances and
    iteration cap) and the repair width, as the JAX package's."""
    kw = dict(margins=margins, cold_restart_from=cold_from,
              brake_factor=brake)
    cfg = dataclasses.replace(PlannerConfig(), repair=dataclasses.replace(
        PlannerConfig().repair, **kw))
    jcfg = dataclasses.replace(JPlannerConfig(), repair=dataclasses.replace(
        JPlannerConfig().repair, **kw))
    rounds = TP._repair_rounds(cfg.repair)
    assert rounds == JP._repair_rounds(jcfg.repair)
    for _, warm, _ in rounds:
        assert (dataclasses.asdict(TP._repair_ilqr_cfg(cfg, warm))
                == dataclasses.asdict(JP._repair_ilqr_cfg(jcfg, warm)))
    assert any(not w for _, w, _ in rounds) == (
        len(margins) > cold_from or (brake < 1.0 and bool(margins)))
    for b in (1, 4, 16, 17, 100, 128, 1000, 1024, 4096):
        assert TP.repair_width(b, 0.125) == JP.repair_width(b, 0.125)


def test_unported_options_raise(scn):
    """Grid mode and frenet mode without a RoadSpec run (held against JAX
    in tests/test_torch_dp_modes.py); grid mode without its BarrierGrid
    and a RoadSpec of another road raise."""
    z = torch.zeros(len(SEEDS), dtype=F64)
    grid_cfg = dataclasses.replace(CFG, dp=dataclasses.replace(
        CFG.dp, collision_mode="grid"))
    with pytest.raises(ValueError, match="BarrierGrid"):
        TD.plan(scn, z, z, z, grid_cfg)
    for cfg, grid in ((grid_cfg, TP.road_grid(scn.barrier_xy[0], CFG)),
                      (CFG, None)):
        d = TD.plan(scn, z, z, z, cfg, grid)
        assert d.sel_s.shape == (len(SEEDS), CFG.dp.nt)
        assert torch.isfinite(d.traj.x).all() and d.ok.any()
    with pytest.raises(ValueError, match="spec/road mismatch|different road"):
        TD.plan(scn, z, z, z, CFG, spec=TS.analytic_road_spec(
            road=(30.0, (-90.0, 10.0), 10.0, (180.0, 5.0), 36.0,
                  (-180.0, 12.0), 50.0, 10.0)))


def test_entry_points_default_to_the_card():
    """No CPU fallback: without device="cpu" the replan's entry points put
    their tensors on the card, which this machine does not have."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        TS.make_scenario_batch([0])
    with pytest.raises((RuntimeError, AssertionError)):
        convert.lane_from_numpy(TP.make_lane_tuple(
            np.zeros((3, 2)) + [[0, 0], [10, 0], [20, 0]],
            np.zeros((3, 2)) + [[0, 1], [10, 1], [20, 1]], CFG))
