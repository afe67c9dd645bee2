"""The DP's kernel path on the CPU (the kernel itself runs only on a card:
tests/test_torch_cuda.py holds it to the plain path bit for bit there).

Cheap: the operands the kernel takes, prepared once a plan, equal those
the plain path prepares layer by layer, and its road-test constants give
the plain road test's hits; the rule that sends a DP to the kernel takes
the two road tests it has on a card and nothing else; a DP on CPU tensors
runs the plain path, counted as chunks, with no launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cilqr_tpu_torch import dp as TD
from cilqr_tpu_torch import pipeline as TP
from cilqr_tpu_torch import profiling as TPr
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch.config import PlannerConfig
from cilqr_tpu_torch.kernels import dpsweep
from cilqr_tpu_torch.world import (barrier_hit_road_spec, build_barrier_grid,
                                   dilate_polys, dyn_polys_at)

CFG = PlannerConfig()
CUDA = torch.device("cuda")


def _mode(mode):
    return dataclasses.replace(CFG, dp=dataclasses.replace(
        CFG.dp, collision_mode=mode))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slabs_hoisted_equal_per_layer(dtype):
    """The obstacles' slabs of every layer from one dyn_polys_at and one
    dilate_polys call over the concatenated probe times equal, bit for
    bit, those of one call per layer at the layer's times, as _plan_chunk
    slices them."""
    scn = TS.make_scenario_batch([0, 156], dtype=dtype, device="cpu")
    sslab, dslab = TD._sweep_slabs(scn, CFG, dtype, "cpu")
    radius = CFG.vehicle.radius
    NT = CFG.dp.nt
    tv = TD._probe_times(CFG, dtype, "cpu")
    assert tv.shape == (17 + 16 * (NT - 1),)
    layers = [tv[:17]] + [tv[17 + 16 * t:33 + 16 * t] for t in range(NT - 1)]

    def dilated(tv):
        polys, active = dyn_polys_at(scn, tv)
        return dpsweep.pack_slabs(dilate_polys(polys, active[..., None],
                                               radius, rect=True))

    per_layer = torch.cat([dilated(tv) for tv in layers], dim=1)
    assert dslab.shape == (2, 17 + 16 * (NT - 1), 9, dpsweep.SLAB)
    assert torch.equal(dslab, per_layer)
    sd = dilate_polys(scn.static_obs, scn.static_mask[..., None], radius,
                      rect=True)
    assert torch.equal(sslab, dpsweep.pack_slabs(sd))
    assert torch.equal(sslab[..., 12], scn.static_mask.to(dtype))


def _grid(half):
    pts = np.array([[0.0, 5.0], [10.0, 5.0], [20.0, -5.0]], np.float32)
    return build_barrier_grid(pts, CFG.dp.grid_cell, half=half,
                              dtype=torch.float32, device="cpu")


SPEC32 = TS.analytic_road_spec(dtype=np.float32)
SPEC64 = TS.analytic_road_spec(dtype=np.float64)
DILATED = _grid(CFG.vehicle.radius)
CASES = {
    "frenet+spec": ("frenet", dict(spec=SPEC32), dpsweep.SPEC),
    "frenet+spec in float64": ("frenet", dict(spec=SPEC64), None),
    "frenet without spec": ("frenet", {}, None),
    "grid+dilated": ("grid", dict(grid=DILATED), dpsweep.GRID),
    "grid+dilated+spec": ("grid", dict(grid=DILATED, spec=SPEC32),
                          dpsweep.GRID_SPEC),
    "grid+dilated+spec in float64": ("grid", dict(grid=DILATED,
                                                  spec=SPEC64), None),
    "grid without dilated": ("grid", dict(grid=_grid(None)), None),
    "grid dilated for another half": ("grid", dict(grid=_grid(1.0)), None),
    "exact": ("exact", {}, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dispatch_rule(case):
    """On a card the kernel takes frenet mode with a RoadSpec and grid
    mode with the probe's dilated table, a RoadSpec (its rows the station
    lookup) in the probes' type, nothing else, at any size of the layer
    grid; on the CPU it takes nothing."""
    mode, road, kmode = CASES[case]
    cfg = _mode(mode)
    assert dpsweep.kernel_mode(cfg, torch.float32, **road) == kmode
    big = dataclasses.replace(cfg, dp=dataclasses.replace(cfg.dp, ns=30))
    for c in (cfg, big):
        for device, want in ((CUDA, kmode is not None),
                             (torch.device("cpu"), False)):
            assert dpsweep.takes_kernel(device, torch.float32, c,
                                        **road) is want, device


def test_cpu_dp_takes_plain_path():
    """A DP on CPU tensors in a mode the kernel has on a card runs the
    plain path: one chunk, no launch, and dp_sweep refuses the tensors."""
    scn = TS.make_scenario_batch([3], dtype=torch.float32, device="cpu")
    cfg = _mode("grid")
    grid = TP.road_grid(scn.barrier_xy[0], cfg)
    z = torch.zeros(1)
    launches = TPr.counters["dp_sweep.launches"]
    with TPr.tracing():
        TD.plan(scn, z, z, z, cfg, grid=grid)
        tr = TPr.collect()
    assert tr.counters["dp.chunks"] == 1
    assert "dp.sweep" not in tr.spans
    assert TPr.counters["dp_sweep.launches"] == launches
    with pytest.raises(ValueError, match="plain path"):
        dpsweep.dp_sweep(cfg, z, z, z, None, None, grid=grid)


def test_spec_barrier_constants_give_the_plain_road_test():
    """The kernel's road-test constants (_spec_barrier, float64 rounded to
    float32), applied as csrc/dpsweep.cu applies them, give
    world.barrier_hit_road_spec's hits, bit for bit, on points scattered
    around the road's barriers."""
    spec = TS.analytic_road_spec(dtype=np.float32)
    half = CFG.vehicle.radius + 0.0
    bar, ring_only = dpsweep._spec_barrier(spec, half)
    q = torch.as_tensor(bar).to(torch.float32)
    scn = TS.make_scenario_batch([0], dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    pts = scn.barrier_xy[0].numpy()[rng.integers(0, 3900, 20000)]
    pts = torch.as_tensor(pts + rng.uniform(-1.5, 1.5, pts.shape),
                          dtype=torch.float32)
    cx, cy = pts[:, 0], pts[:, 1]
    got = torch.zeros(cx.shape, dtype=torch.bool)
    for g, arc in enumerate(np.asarray(spec.is_arc)):
        if not arc:
            for u in range(2):
                c = q[g, 8 * u:8 * u + 8]
                sv = (cx * c[4] + cy * c[5]) - c[6]
                got |= ((cx >= c[0]) & (cx <= c[1]) & (cy >= c[2])
                        & (cy <= c[3]) & (sv.abs() <= c[7]))
            continue
        adx, ady = cx - q[g, 0], cy - q[g, 1]
        pdx = torch.clamp(adx.abs() - q[g, 2], min=0.0)
        pdy = torch.clamp(ady.abs() - q[g, 2], min=0.0)
        sdx, sdy = adx.abs() + q[g, 2], ady.abs() + q[g, 2]
        dmin2, dmax2 = pdx * pdx + pdy * pdy, sdx * sdx + sdy * sdy
        for u in range(2):
            c = q[g, 3 + 4 * u:7 + 4 * u]
            ring = (dmin2 <= c[0]) & (c[0] <= dmax2)
            if not ring_only[g, u]:
                ring &= (adx * c[1] + ady * c[2]) >= c[3]
            got |= ring
    want = barrier_hit_road_spec(half, cx, cy, spec)
    assert want.any() and not want.all()
    assert torch.equal(got, want)
