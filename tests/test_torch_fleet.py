"""A batch whose lanes are on roads of their own (the port only; the JAX
package plans one road a batch): ``pipeline.plan_batch`` with a RoadLibrary
against one plan_batch a road, the library's batched build against
``world.build_barrier_grid`` road by road, the padded centerline's lookups
against the unpadded ones, and the benchmark's road family against
overlapping itself.

Cheap: three drawn roads of two lanes each in float64 on the CPU, the
single-problem solver, no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from cilqr_tpu_torch import dp as TD
from cilqr_tpu_torch import pipeline as TP
from cilqr_tpu_torch import reference_line as TR
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch.config import PlannerConfig
from portbench import fleet
from portbench.fleet_ref import widen

F64 = torch.float64
CFG = PlannerConfig()
GRID = dataclasses.replace(CFG, dp=dataclasses.replace(
    CFG.dp, collision_mode="grid"))
FAMILY = {"roads": {"base": [list(s) if isinstance(s, tuple) else s
                             for s in TS.DEFAULT_ROAD],
                    "factor": [1.0, 1.5]}}
LANES = 2                       # lanes a road


def _road_rows(road, seeds):
    cl = TS.make_centerline(road)
    bar = TS.build_road_barriers(cl)
    return [TS.make_scenario_arrays(s, road=road, cl=cl, barriers=bar)
            for s in seeds]


@pytest.fixture(scope="module")
def fleet_world():
    """Three roads of the family, two lanes each (lane 2r + k on road r),
    stacked padded; each road's lanes stacked alone; starts moved on y."""
    roads = fleet.draw_roads(FAMILY, 2**31 + 21, 3)
    per_road = [_road_rows(road, [100 * r + k for k in range(LANES)])
                for r, road in enumerate(roads)]
    rows = [x for rr in per_road for x in rr]
    scns = TS.scenario_from_arrays(TS.stack_scenario_arrays(rows), F64,
                                   "cpu")
    alone = [TS.scenario_from_arrays(TS.stack_scenario_arrays(rr), F64,
                                     "cpu") for rr in per_road]
    dy = np.random.default_rng(3).uniform(-0.2, 0.2, len(rows))
    starts = torch.tensor([[0.0, d, 0.0, 10.0] for d in dy], dtype=F64)
    lib = TP.road_library(scns.map(lambda a: a[::LANES]), GRID)
    idx = torch.arange(len(rows)) // LANES
    out = TP.plan_batch(scns, starts, GRID, backend="vmap", library=lib,
                        roads=idx)
    return dict(roads=roads, scns=scns, alone=alone, starts=starts, lib=lib,
                idx=idx, out=out)


def _lanes(r):
    return slice(LANES * r, LANES * (r + 1))


def test_library_build_equals_the_road_grids(fleet_world):
    """Road by road, the batched build's dilated table, origin, H and W
    equal build_barrier_grid's from the road's own points, bit for bit."""
    lib = fleet_world["lib"]
    for r, one in enumerate(fleet_world["alone"]):
        g = TP.road_grid(one.barrier_xy[0], GRID)
        n = g.dilated.numel()
        o = int(lib.offset[r])
        assert torch.equal(lib.dilated[o:o + n], g.dilated.reshape(-1))
        assert torch.equal(lib.origin[r], g.origin)
        assert lib.hw[r].tolist() == [g.integral.shape[0] - 1,
                                      g.integral.shape[1] - 1]
        assert int(lib.rows[r]) == one.centerline.s.shape[-1]
    assert lib.dilated.numel() == int(lib.offset[-1]) + n


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_library_lanes_equal_make_lane_tuple(fleet_world, dtype):
    """The one-pass lane constraints of the library's roads equal
    make_lane_tuple road by road, bit for bit, from float64 polylines and
    (as on the card's scenarios) float32 ones."""
    from cilqr_tpu_torch import corridor as TC

    one = fleet_world["alone"]
    lib = fleet_world["lib"]
    pad = fleet_world["scns"].map(lambda a: a[::LANES])

    def polys(s):
        return tuple(a.numpy().astype(dtype) if a.is_floating_point()
                     else a.numpy() for a in (
                         s.left_barrier_xy, s.left_barrier_mask,
                         s.right_barrier_xy, s.right_barrier_mask))

    got = TC.lane_constraints_batch(*polys(pad), GRID.corridor, dtype)
    for r, o in enumerate(one):
        lx, lm, rx, rm = polys(o.map(lambda a: a[:1]))
        want = TP.make_lane_tuple(lx[0][lm[0]], rx[0][rm[0]], GRID, dtype)
        for a, b in zip(got, want):
            assert a[r].dtype == b.dtype and np.array_equal(a[r], b)
    if dtype is np.float64:          # the library's own, from its scenarios
        for a, b in zip(lib.lanes, got):
            assert np.array_equal(a.numpy(), b)


def test_padded_centerline_lookups_equal_the_road_alone(fleet_world):
    """The station lookup of a padded table with the table's own row
    count, and the projection, equal the unpadded table's bit for bit,
    past the road's end too."""
    scns, lib = fleet_world["scns"], fleet_world["lib"]
    for r, one in enumerate(fleet_world["alone"]):
        pad = scns.centerline.map(lambda a: a[_lanes(r)])
        own = one.centerline
        n = own.s.shape[-1]
        assert pad.s.shape[-1] >= n
        rows = lib.rows[fleet_world["idx"][_lanes(r)]]
        assert torch.equal(TR.centerline_rows(pad.s), rows)
        st = torch.linspace(-5.0, float(own.s[0, -1]) + 40.0, 997,
                            dtype=F64).expand(LANES, -1)
        got = TR.evaluate_station_fields(pad, st, packed=TR.pack_station_rows(
            pad), rows=rows)
        want = TR.evaluate_station_fields(own, st,
                                          packed=TR.pack_station_rows(own))
        for f in TR.DP_FIELDS:
            assert torch.equal(got[f], want[f]), f
        px = own.x[:, ::97] + 0.3
        py = own.y[:, ::97] - 0.2
        for a, b in zip(TR.get_projection(pad, px, py)[:2],
                        TR.get_projection(own, px, py)[:2]):
            assert torch.equal(a, b)


def _dp_equal(got, want):
    for f in ("sel_s", "sel_l", "min_cost", "ok"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in TR.TRAJ_FIELDS:
        assert torch.equal(getattr(got.traj, f), getattr(want.traj, f)), f


def test_library_batch_equals_one_batch_a_road(fleet_world):
    """plan_batch over the library equals plan_batch of each road's lanes
    on their road alone: every DpResult field, the corridors and the
    constraints bit for bit (the batch's constraints keep the widest
    lane's slots, the rest masked out), the re-checks and the ladder's
    bookkeeping equal, and the solve's status and iterations."""
    w = fleet_world
    scns, starts, lib, idx = w["scns"], w["starts"], w["lib"], w["idx"]
    out = w["out"]
    grid, lane, rows = TP.lane_roads(lib, idx)
    d_lib = TD.plan(scns, starts[:, 0], starts[:, 1], starts[:, 2], GRID,
                    grid, rows=rows)
    cons = TP.prep_constraints(out.corridors, GRID)
    kc, s = cons.corridor_mask.shape[-1], cons.left_mask.shape[-1]
    for r, one in enumerate(w["alone"]):
        sl = _lanes(r)
        st = starts[sl]
        want = TP.plan_batch(one, st, GRID, backend="vmap")
        g = TP.road_grid(one.barrier_xy[0], GRID)
        d_one = TD.plan(one, st[:, 0], st[:, 1], st[:, 2], GRID, g)
        _dp_equal(TD.DpResult(d_lib.traj.map(lambda a: a[sl]),
                              *(v[sl] for v in d_lib[1:])), d_one)
        for f in TR.TRAJ_FIELDS:
            assert torch.equal(getattr(out.coarse, f)[sl],
                               getattr(want.coarse, f)), f
        assert torch.equal(out.dp_ok[sl], want.dp_ok)
        for f in dataclasses.fields(out.corridors):
            assert torch.equal(getattr(out.corridors, f.name)[sl],
                               getattr(want.corridors, f.name)), f.name
        c1 = TP.prep_constraints(want.corridors, GRID)
        for a, b in zip(cons, widen(c1, kc, s)):
            assert torch.equal(a[sl], b)
        for f in ("ok", "solve_hits", "pre_hits", "repaired",
                  "still_dirty"):
            assert torch.equal(getattr(out, f)[sl], getattr(want, f)), f
        assert torch.equal(out.solve.status[sl], want.solve.status)
        assert torch.equal(out.solve.iters[sl], want.solve.iters)


def test_library_call_rejects_a_shared_road(fleet_world):
    w = fleet_world
    with pytest.raises(ValueError, match="RoadLibrary"):
        TP.plan_batch(w["scns"], w["starts"], GRID, backend="vmap",
                      library=w["lib"], roads=w["idx"],
                      spec=TS.analytic_road_spec())
    with pytest.raises(ValueError, match="no road index"):
        TP.plan_batch(w["scns"], w["starts"], GRID, backend="vmap",
                      library=w["lib"])


@pytest.mark.parametrize("seed", range(4))
def test_drawn_roads_keep_their_barriers_off_their_own_band(seed):
    """Every barrier point of a drawn road lies at least the road's bound
    (2.5 m, the narrower side) from every knot of its own centerline, less
    the chord's sag between two 0.1 m knots on the tightest arc (a
    barrier point is offset from an interpolated station): the road does
    not overlap itself."""
    for road in fleet.draw_roads(FAMILY, 7919 * seed + 2**31, 2):
        cl, (both, _, _) = fleet.road_arrays(road)
        c = np.stack([cl.x, cl.y], -1)
        near = np.inf
        for p0 in range(0, len(both), 512):
            d = both[p0:p0 + 512, None, :] - c[None]
            near = min(near, float(np.sqrt((d * d).sum(-1)).min()))
        assert near >= TS.LEFT_BOUND - 1e-3, (road, near)
        assert cl.s[-1] >= 195.0
