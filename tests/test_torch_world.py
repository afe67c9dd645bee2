"""The port's road-barrier grid, the frenet stand-in, the per-probe track
lookup, check_collision, every mode of check_optimization_collision and
the geometry functions under them, against the JAX package on the CPU
on the same inputs (float64 unless stated). The JAX functions run op by
op, except the three scenario-level checks, which run jitted and vmapped
over the scenarios (one compile each instead of hundreds of op-by-op
ones); their probes are random, so a multiply-add XLA fuses there moves
no probe across a box, polygon or barrier-point boundary.

Tolerances: every boolean hit, grid count, cell index and table is
identical (the same operations in the same order); the distances of
polygon_distance_point within 1e-12 (JAX's hypot is not the C library's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import geometry as JG
from cilqr_tpu import scenario as JS
from cilqr_tpu import world as JW
from cilqr_tpu_torch import convert
from cilqr_tpu_torch import geometry as TG
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch import world as TW
from cilqr_tpu_torch.config import PlannerConfig

SEEDS = (3, 5)
CFG = PlannerConfig()
VEH = CFG.vehicle
F64 = torch.float64


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.fixture(scope="module")
def jscn():
    return JS.make_scenario_batch(SEEDS, dtype=jnp.float64)


@pytest.fixture(scope="module")
def scn():
    return TS.make_scenario_batch(SEEDS, dtype=F64, device="cpu")


@pytest.fixture(scope="module")
def grids(jscn, scn):
    """JAX's and the port's grid of the road, with the dilated table for
    the vehicle radius."""
    xy = np.asarray(jscn.barrier_xy[0])
    return (JW.build_barrier_grid(xy, CFG.dp.grid_cell, half=VEH.radius),
            TW.build_barrier_grid(scn.barrier_xy[0], CFG.dp.grid_cell,
                                  half=VEH.radius, device="cpu"))


def _probes(scn, rng, n):
    """Disc-box centres [B, n] around the barrier points and obstacles."""
    B = scn.barrier_xy.shape[0]
    bxy = _np(scn.barrier_xy)
    obs = _np(scn.dyn_obs[:, :, ::31, 0]).reshape(B, -1, 2)
    pick = rng.integers(0, bxy.shape[1], (B, n // 2))
    c = np.concatenate([np.take_along_axis(bxy, pick[..., None], 1),
                        obs[:, rng.integers(0, obs.shape[1], n - n // 2)]],
                       axis=1)
    return c + rng.normal(0.0, 1.2, c.shape)


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    polys = rng.normal(0.0, 3.0, (40, 5, 2))
    mask = rng.uniform(size=(40, 5)) < 0.8
    mask[0] = False
    px, py = rng.normal(0.0, 4.0, (2, 40))
    got = TG.polygon_distance_point(torch.tensor(px), torch.tensor(py),
                                    torch.tensor(polys), torch.tensor(mask))
    want = JG.polygon_distance_point(jnp.asarray(px), jnp.asarray(py),
                                     jnp.asarray(polys), jnp.asarray(mask))
    np.testing.assert_array_equal(np.isinf(_np(got)), np.isinf(want))
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_allclose(_np(got)[fin], np.asarray(want)[fin],
                               rtol=0, atol=1e-12)
    assert fin.sum() == 39 and (np.asarray(want)[fin] == 0).any()

    cx, cy, th = rng.normal(0.0, 2.0, (3, 40, 1))
    qx, qy = rng.normal(0.0, 3.0, (2, 40, 30))
    got = TG.point_in_oriented_box(*map(torch.tensor, (qx, qy, cx, cy, th)),
                                   3.0, 1.9)
    want = JG.point_in_oriented_box(*map(jnp.asarray, (qx, qy, cx, cy, th)),
                                    3.0, 1.9)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert 0 < int(np.asarray(want).sum()) < want.size

    m = rng.uniform(size=(40, 30)) < 0.9
    box = (cx - 1.5, cy - 1.0, cx + 1.5, cy + 1.0)
    got = TG.points_in_aabb_count(torch.tensor(qx), torch.tensor(qy),
                                  *map(torch.tensor, box), torch.tensor(m))
    want = JG.points_in_aabb_count(jnp.asarray(qx), jnp.asarray(qy),
                                   *map(jnp.asarray, box), jnp.asarray(m))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_build_barrier_grid_tables_equal(jscn, scn, grids):
    jg, tg = grids
    np.testing.assert_array_equal(_np(tg.integral), np.asarray(jg.integral))
    np.testing.assert_array_equal(_np(tg.dilated), np.asarray(jg.dilated))
    np.testing.assert_array_equal(_np(tg.origin), np.asarray(jg.origin))
    assert (tg.cell, tg.half, tg.span) == (jg.cell, jg.half, jg.span)
    assert tg.integral.dtype == torch.int32 and tg.dilated.dtype == torch.int8
    # from float32 points, as the JAX package's plan builds it in float32
    xy32 = np.asarray(jscn.barrier_xy[0], np.float32)
    j32 = JW.build_barrier_grid(xy32, CFG.dp.grid_cell)
    t32 = TW.build_barrier_grid(torch.tensor(xy32), CFG.dp.grid_cell,
                                dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(_np(t32.integral), np.asarray(j32.integral))
    assert t32.dilated is None and t32.origin.dtype == torch.float32
    # and through convert, from the JAX package's grid
    c = convert.barrier_grid_from_numpy(jg, device="cpu")
    assert torch.equal(c.dilated, tg.dilated) and torch.equal(c.origin,
                                                              tg.origin)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_grid_lookups_match_jax(grids, scn, dtype):
    """Integral counts and dilated hits of boxes of the grid's half-size,
    identical to JAX's, and the dilated hits identical to (count > 0):
    around barrier points, off the grid, and with the box's edges placed
    exactly on cell boundaries and one ulp either side of them. float32
    boxes against a float64 origin compute their cells in float64, as
    JAX's do; against a float32 origin, in float32."""
    jg, tg = grids
    rng = np.random.default_rng(1)
    h = VEH.radius
    c = _probes(scn, rng, 200)[0]
    org = np.asarray(jg.origin)
    k = rng.integers(20, 600, (200, 2))
    edge = org + k * jg.cell            # a box edge on a cell boundary
    on = np.concatenate([edge + h, edge - h])  # min or max edge there
    on = np.concatenate([on, np.nextafter(on, np.inf),
                         np.nextafter(on, -np.inf)])
    c = np.concatenate([c, on, [[-1e3, -1e3], [1e4, 50.0]]])
    np_dt = np.dtype(dtype)
    c = c.astype(np_dt)
    mn, mx = (c - np_dt.type(h)).astype(np_dt), (c + np_dt.type(h)).astype(
        np_dt)
    boxes_j = tuple(jnp.asarray(v) for v in (mn[:, 0], mn[:, 1], mx[:, 0],
                                             mx[:, 1]))
    boxes_t = tuple(torch.tensor(v) for v in (mn[:, 0], mn[:, 1], mx[:, 0],
                                              mx[:, 1]))
    grids_t = [tg]
    grids_j = [jg]
    if dtype == "float32":
        grids_t.append(tg._replace(origin=tg.origin.float()))
        grids_j.append(jg._replace(origin=jg.origin.astype(jnp.float32)))
    for gj, gt in zip(grids_j, grids_t):
        cnt_j = np.asarray(JW.barrier_points_in_box_grid(gj, *boxes_j))
        cnt_t = _np(TW.barrier_points_in_box_grid(gt, *boxes_t))
        np.testing.assert_array_equal(cnt_t, cnt_j)
        hit_j = np.asarray(JW.barrier_box_hit_dilated(gj, *boxes_j))
        hit_t = _np(TW.barrier_box_hit_dilated(gt, *boxes_t))
        np.testing.assert_array_equal(hit_t, hit_j)
        np.testing.assert_array_equal(hit_t, cnt_t > 0)
        assert 0 < hit_t.sum() < len(hit_t)
        # the cell index itself, at the boundaries
        for ax in (0, 1):
            want = np.floor((jnp.asarray(mn[:, ax]) - gj.origin[ax])
                            / gj.cell).astype(np.int64)
            np.testing.assert_array_equal(
                _np(TW._cell_index(gt, boxes_t[ax], ax)), np.asarray(want))


def test_frenet_stand_in_matches_jax():
    """_box_hits_line and barrier_hit_frenet on straights (kappa 0, and
    near-vertical and near-horizontal directions) and arcs of both signs,
    boxes near the boundaries."""
    rng = np.random.default_rng(2)
    n = 400
    rx, ry = rng.uniform(-50, 50, (2, n))
    th = rng.uniform(-np.pi, np.pi, n)
    th[:40] = np.pi / 2 + rng.normal(0, 1e-7, 40)
    th[40:80] = rng.normal(0, 1e-7, 40)
    kap = np.where(rng.uniform(size=n) < 0.5, 0.0,
                   rng.choice([0.2, -0.1, -1 / 12, 0.05], n))
    lb, rb = np.full(n, 3.5), np.full(n, 3.0)
    lat = rng.uniform(-5.0, 5.0, n)
    cx = rx - lat * np.sin(th) + rng.normal(0, 0.3, n)
    cy = ry + lat * np.cos(th) + rng.normal(0, 0.3, n)
    h = VEH.radius
    args = (cx, cy, rx, ry, th, kap, lb, rb)
    got = TW.barrier_hit_frenet(h, *map(torch.tensor, args))
    want = JW.barrier_hit_frenet(h, *map(jnp.asarray, args))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert 0.05 < np.asarray(want).mean() < 0.95
    cs, sn = np.cos(th), np.sin(th)
    largs = (cx, cy, rx - 2.0 * sn, ry + 2.0 * cs, cs, sn)
    got = TW._box_hits_line(h, *map(torch.tensor, largs))
    want = JW._box_hits_line(h, *map(jnp.asarray, largs))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert 0 < np.asarray(want).sum() < n


def test_dynamic_obstacle_overlap_with_time(jscn, scn):
    """The per-probe track lookup: every probe at its own time, including
    times on track samples, before a track starts and after it ends."""
    rng = np.random.default_rng(3)
    c = _probes(scn, rng, 120)
    t = np.round(rng.uniform(-0.5, 17.0, c.shape[:2]), 1)
    t[:, :10] = _np(scn.dyn_times[:, :, 0])[:, :1] + 0.05
    half = 1.0
    mn, mx = c - half, c + half
    got = TW.dynamic_obstacle_overlap(
        scn, torch.tensor(t), *(torch.tensor(v) for v in (
            mn[..., 0], mn[..., 1], mx[..., 0], mx[..., 1])))
    polys, active = TW._dyn_polygons_at(scn, torch.tensor(t))
    corners, active = polys[:, :, 2], active[:, :, 2]       # obstacle 2
    want = jax.jit(jax.vmap(JW.dynamic_obstacle_overlap))(
        jscn, jnp.asarray(t), *(jnp.asarray(v) for v in (
            mn[..., 0], mn[..., 1], mx[..., 0], mx[..., 1])))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    jc, ja = jax.jit(jax.vmap(jax.vmap(
        lambda s1, q: JW._dyn_polygon_at(s1, 2, q), (None, 0))))(
            jscn, jnp.asarray(t))
    np.testing.assert_array_equal(_np(corners), np.asarray(jc))
    np.testing.assert_array_equal(_np(active), np.asarray(ja))
    assert 0 < int(np.asarray(want).sum()) < got.numel()


def test_check_collision_matches_jax(jscn, scn):
    """tests/test_scenario_world.py's cases (an ego box on a static
    obstacle, far off the road at three headings, a batch of both), and
    random poses near the barrier and the obstacles at several times."""
    rng = np.random.default_rng(4)
    B = len(SEEDS)
    obs = _np(scn.static_obs)[:, 0].mean(axis=1)            # [B, 2]
    cx = np.concatenate([obs[:, :1], np.full((B, 3), 500.0)], 1)
    cy = np.concatenate([obs[:, 1:], np.full((B, 3), 500.0)], 1)
    th = np.tile([0.3, 0.0, 0.7, 2.0], (B, 1))
    c = _probes(scn, rng, 60)
    cx = np.concatenate([cx, c[..., 0]], 1)
    cy = np.concatenate([cy, c[..., 1]], 1)
    th = np.concatenate([th, rng.uniform(-np.pi, np.pi, c.shape[:2])], 1)
    t = np.concatenate([np.zeros((B, 4)), np.round(
        rng.uniform(0.0, 8.0, c.shape[:2]), 1)], 1)
    got = TW.check_collision(scn, *map(torch.tensor, (t, cx, cy, th)), 3.0,
                             1.9)
    assert _np(got[:, 0]).all() and not _np(got[:, 1:4]).any()
    want = jax.jit(jax.vmap(lambda *a: JW.check_collision(*a, 3.0, 1.9)))(
        jscn, *(jnp.asarray(v) for v in (t, cx, cy, th)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert 4 < int(got.sum()) < got.numel()


def test_check_optimization_collision_every_mode(jscn, scn, grids):
    """grid (the dilated table and the integral image), exact, frenet with
    the station fields, skiproad, the dynamic obstacles by per-probe time;
    and in grid mode also by dyn_polys and by dilated polygons. (Frenet
    with the RoadSpec: tests/test_torch_replan.py.)"""
    jg, tg = grids
    rng = np.random.default_rng(5)
    B = len(SEEDS)
    c = _probes(scn, rng, 48)
    times = np.round(np.linspace(0.0, 4.7, 48), 1)
    th = rng.uniform(-np.pi, np.pi, c.shape[:2])
    x, y = c[..., 0], c[..., 1]
    # station fields at each probe's projection, the frenet stand-in's
    from cilqr_tpu_torch import reference_line as TR
    st, _, _ = TR.get_projection(scn.centerline, torch.tensor(x),
                                 torch.tensor(y))
    ref = TR.evaluate_station_fields(scn.centerline, st)
    frenet_t = tuple(ref[k] for k in ("x", "y", "theta", "kappa",
                                      "left_bound", "right_bound"))
    tt = torch.tensor(times).expand(B, -1)
    dyn_t = TW.dyn_polys_at(scn, tt)
    sd = TW.dilate_polys(scn.static_obs, scn.static_mask[..., None],
                         VEH.radius, rect=True)
    dd = TW.dilate_polys(dyn_t[0], dyn_t[1][..., None], VEH.radius,
                         rect=True)
    dil_t = (sd.map(lambda a: a[:, None]), dd)
    args_t = (torch.tensor(x), torch.tensor(y), torch.tensor(th),
              VEH.radius, VEH.r2x, VEH.f2x)
    cases = [("grid", dict(grid=tg), dict(grid=jg)),
             ("grid", dict(grid=tg, collision_buffer=0.05),
              dict(grid=jg, collision_buffer=0.05)),       # integral image
             ("exact", {}, {}),
             ("frenet", dict(frenet=frenet_t), "frenet"),
             ("skiproad", {}, {})]
    total = 0
    for i, (mode, kw_t, kw_j) in enumerate(cases):
        # every mode with the per-probe lookup, the DP's and the
        # re-check's forms of the dynamic obstacles with the first
        for dyn in ("time", "dyn_polys", "dilated") if i == 0 else ("time",):
            extra = {"time": dict(time=tt), "dyn_polys": dict(
                dyn_polys=dyn_t), "dilated": dict(dilated=dil_t)}[dyn]
            got = TW.check_optimization_collision(scn, *args_t, mode=mode,
                                                  **kw_t, **extra)

            def one(s1, xb, yb, thb, fr, kj=kw_j, dyn=dyn, mode=mode):
                if kj == "frenet":
                    kj = dict(frenet=fr)
                jd = JW.dyn_polys_at(s1, jnp.asarray(times))
                jextra = {"time": {}, "dyn_polys": dict(dyn_polys=jd),
                          "dilated": dict(dilated=(
                              JW.dilate_polys(s1.static_obs,
                                              s1.static_mask[:, None],
                                              VEH.radius, rect=True),
                              JW.dilate_polys(jd[0], jd[1][..., None],
                                              VEH.radius, rect=True)))}[dyn]
                return JW.check_optimization_collision(
                    s1, jnp.asarray(times), xb, yb, thb, VEH.radius,
                    VEH.r2x, VEH.f2x, mode=mode, **kj, **jextra)

            want = jax.jit(jax.vmap(one))(
                jscn, jnp.asarray(x), jnp.asarray(y), jnp.asarray(th),
                tuple(jnp.asarray(_np(f)) for f in frenet_t))
            np.testing.assert_array_equal(_np(got), np.asarray(want),
                                          err_msg=f"{mode} {kw_t} {dyn}")
            total += int(got.sum())
    assert 0 < total
    with pytest.raises(ValueError, match="BarrierGrid"):
        TW.check_optimization_collision(scn, *args_t, mode="grid", time=tt)
    with pytest.raises(ValueError, match="RoadSpec or the"):
        TW.check_optimization_collision(scn, *args_t, mode="frenet", time=tt)
