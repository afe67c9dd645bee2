"""The DP's layer sweep on the card: the CUDA kernel ``csrc/dpsweep.cu``,
the rule that sends a DP to it, and the operands it takes.

Replaces no TPU kernel (the JAX package's DP is plain XLA). ``dp.plan``
sends a batch here when its inputs allow it (``takes_kernel``): CUDA
tensors, and one of the two road tests the replans run, frenet mode with
a RoadSpec or grid mode with a BarrierGrid whose dilated table is for the
probe's half. The station lookup is the plain path's: the RoadSpec's
closed-form rows wherever a spec is given (grid mode too), else the
packed centerline rows. Where each scenario is on a road of its own (a
world.LaneGrid, and the scenarios' row counts), each CTA reads its own
road's table and rows. Everything else takes the plain path,
``dp._plan_chunk``, which this kernel matches bit for bit on the card:
CPU tensors, exact mode, frenet mode without a RoadSpec, a grid without
that table, and a RoadSpec in another type than the probes' (the plain
path mixes the two types as PyTorch promotes them; the kernel computes in
one). There is no other plain version: ``dp_sweep`` raises on a CPU
tensor, and a launch whose obstacles do not fit a CTA's shared memory
fails (``check``) rather than falling back.

The kernel runs the first layer and the NT-1 transitions of every
scenario in one launch and hands back, per layer, each cell's cost, its
accumulated station and its parent's station and lateral indices
([NT, B, NS * NL] each), what ``dp._trace_back`` reads.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import profiling
from ..world import DilatedPolys, LaneGrid
from . import _build

SLAB = 13               # a dilated slab's columns (csrc/dpsweep.cu: kSlab)
NSEG0, NSEG = 17, 16    # points of the first layer and of the later ones
# the kernel's station lookup and road test (csrc/dpsweep.cu: Mode)
SPEC = 0        # the RoadSpec's rows and its finite per-segment test
GRID = 1        # the packed centerline rows and the dilated grid
GRID_SPEC = 2   # the RoadSpec's rows and the dilated grid


def kernel_mode(cfg, dtype, grid=None, spec=None):
    """The kernel's station lookup and road test for these inputs (SPEC,
    GRID or GRID_SPEC), or None where the DP takes the plain path: frenet
    mode with a RoadSpec, or grid mode with a dilated table for the
    probe's half (the one-gather test check_optimization_collision takes),
    any RoadSpec in the working type."""
    if spec is not None:
        want = np.float32 if dtype == torch.float32 else np.float64
        if np.asarray(spec.h).dtype != want:
            return None
    mode = cfg.dp.collision_mode
    if mode == "frenet" and spec is not None:
        return SPEC
    if (mode == "grid" and grid is not None and grid.dilated is not None
            and grid.half == cfg.vehicle.radius + 0.0):
        return GRID if spec is None else GRID_SPEC
    return None


def takes_kernel(device, dtype, cfg, grid=None, spec=None) -> bool:
    """Whether dp.plan runs the layer sweep as this kernel: CUDA tensors
    of float32 or float64 and a lookup and road test the kernel has."""
    if torch.device(device).type != "cuda":
        return False
    if dtype not in (torch.float32, torch.float64):
        return False
    return kernel_mode(cfg, dtype, grid, spec) is not None


def pack_slabs(d: DilatedPolys) -> torch.Tensor:
    """DilatedPolys of rectangles (two edges) as one [..., SLAB] tensor:
    nx, ny, lo, hi (two each), minx, miny, maxx, maxy, valid (0 or 1)."""
    one = [v[..., None] for v in (d.minx, d.miny, d.maxx, d.maxy)]
    return torch.cat([d.nx, d.ny, d.lo, d.hi, *one,
                      d.valid[..., None].to(d.nx.dtype)], dim=-1).contiguous()


def _spec_barrier(spec, half: float, pad: float = 0.05):
    """world.barrier_hit_road_spec's per-segment constants, in float64 and
    formed as it forms them: [G, 16] values and [G, 2] ring-only flags. A
    straight's side u holds lox hix loy hiy -dy dx ncx nslack at 8u; an
    arc holds xc yc hp, then rb*rb cmid smid thresh at 3 + 4u."""
    hp = half + pad
    res = float(spec.h)
    is_arc = np.asarray(spec.is_arc)
    cnt = np.asarray(spec.count, np.float64)
    kap = np.asarray(spec.kappa, np.float64)
    ang0 = np.asarray(spec.ang0, np.float64)
    dang = np.asarray(spec.dang, np.float64)
    xc = np.asarray(spec.xc, np.float64)
    yc = np.asarray(spec.yc, np.float64)
    x0 = np.asarray(spec.x0, np.float64)
    y0 = np.asarray(spec.y0, np.float64)
    stepx = np.asarray(spec.stepx, np.float64)
    stepy = np.asarray(spec.stepy, np.float64)
    sides = (float(spec.lb), -float(spec.rb))
    G = len(is_arc)
    bar = np.zeros((G, 16), np.float64)
    ring_only = np.zeros((G, 2), np.int32)
    for g in range(G):
        if not is_arc[g]:
            dx_, dy_ = stepx[g] / res, stepy[g] / res
            L = (cnt[g] - 1.0) * res
            for k, u in enumerate(sides):
                p0x = x0[g] + stepx[g] - u * dy_ - res * dx_
                p0y = y0[g] + stepy[g] + u * dx_ - res * dy_
                p1x = p0x + (L + 2 * res) * dx_
                p1y = p0y + (L + 2 * res) * dy_
                lox, hix = min(p0x, p1x) - hp, max(p0x, p1x) + hp
                loy, hiy = min(p0y, p1y) - hp, max(p0y, p1y) + hp
                nslack = hp * (abs(dy_) + abs(dx_))
                ncx = -dy_ * p0x + dx_ * p0y
                bar[g, 8 * k:8 * k + 8] = (lox, hix, loy, hiy, -dy_, dx_,
                                           ncx, nslack)
        else:
            inv = 1.0 / kap[g]
            span = (cnt[g] - 1.0) * dang[g]
            hw = min(abs(span) / 2 + abs(dang[g]), np.pi)
            bar[g, :3] = (xc[g], yc[g], hp)
            for k, u in enumerate(sides):
                rb = abs(inv - u)
                bar[g, 3 + 4 * k] = rb * rb
                if hw >= np.pi:
                    ring_only[g, k] = 1
                    continue
                refl = np.pi if np.sign(kap[g]) * (inv - u) < 0 else 0.0
                mid = ang0[g] + refl + span / 2
                cmid, smid = np.cos(mid), np.sin(mid)
                thresh = rb * np.cos(hw) - hp * (abs(cmid) + abs(smid))
                bar[g, 4 + 4 * k:7 + 4 * k] = (cmid, smid, thresh)
    return bar, ring_only


def spec_operands(spec, half: float, dtype, device):
    """The RoadSpec's tensors for the kernel, built once per spec, half,
    type and device (kept in the spec's tensor cache): the row recipe
    [G, 12] in the spec's own values, the road test's constants [G, 16]
    rounded from float64 to the working type, and the integer columns
    [G, 5] (row_start, count, is_arc, ring-only flags)."""
    key = f"dpsweep:{torch.device(device)}:{dtype}:{half!r}"
    if key not in spec._on:
        cols = ("xc", "yc", "radius", "ang0", "dang", "yaw0", "yaw_inc",
                "kappa", "x0", "y0", "stepx", "stepy")
        seg_f = np.stack([np.asarray(getattr(spec, c)) for c in cols], -1)
        bar, ring_only = _spec_barrier(spec, half)
        seg_i = np.concatenate(
            [np.stack([np.asarray(spec.row_start, np.int32),
                       np.asarray(spec.count, np.int32),
                       np.asarray(spec.is_arc, np.int32)], -1), ring_only],
            -1)
        spec._on[key] = (
            profiling.upload(seg_f, dtype=dtype, device=device),
            profiling.upload(bar, dtype=dtype, device=device),
            profiling.upload(np.ascontiguousarray(seg_i), device=device))
    return spec._on[key]


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def dp_sweep(cfg, s0, l0, station, sslab, dslab, packed=None, grid=None,
             spec=None, rows=None):
    """The layer sweep of B scenarios in one launch.

    s0, l0 [B]: the start's station and lateral; station [NS]; sslab
    [B, KS, SLAB] and dslab [B, TK, KD, SLAB] (``pack_slabs``) the static
    and dynamic obstacles dilated by the vehicle radius, the dynamic ones
    at every layer's probe times (17 for the first layer, then 16 a
    transition); packed [B, rows, 8] the centerline's station rows (read
    where no spec is given); grid or spec as ``kernel_mode`` takes them: a
    world.LaneGrid gives each scenario its own road's table; rows [B]
    (int64) each scenario's centerline row count where ``packed`` is
    padded (None: all of them).

    Returns (cost, cur_s, parent_s_ind, parent_l_ind), [NT, B, NS * NL]
    each, the indices int64 and -1 on the first layer."""
    dev, dtype = s0.device, s0.dtype
    if dev.type != "cuda":
        raise ValueError("dp_sweep runs on a card; on the CPU the DP takes "
                         "its plain path (dp._plan_chunk)")
    if not takes_kernel(dev, dtype, cfg, grid, spec):
        raise ValueError("dp_sweep: these inputs take the DP's plain path")
    dp = cfg.dp
    B = s0.shape[0]
    NT, NS, NL = dp.nt, dp.ns, dp.nl
    P = NS * NL
    TK = NSEG0 + NSEG * (NT - 1)
    KS, KD = sslab.shape[1], dslab.shape[2]
    mode = kernel_mode(cfg, dtype, grid, spec)
    expect = {"s0": (s0, (B,)), "l0": (l0, (B,)), "station": (station, (NS,)),
              "sslab": (sslab, (B, KS, SLAB)),
              "dslab": (dslab, (B, TK, KD, SLAB))}
    if spec is None:
        expect["packed"] = (packed, (B, packed.shape[1], 8))
    elif rows is not None:
        raise ValueError("dp_sweep: a RoadSpec describes one road; rows "
                         "are for padded centerline rows")
    for name, (v, shape) in expect.items():
        if tuple(v.shape) != shape:
            raise ValueError(f"dp_sweep: {name} has shape {tuple(v.shape)}, "
                             f"expected {shape}")
        if v.dtype != dtype or v.device != dev or not v.is_contiguous():
            raise ValueError(f"dp_sweep: {name} is {v.dtype} on {v.device}, "
                             f"expected contiguous {dtype} on {dev}")
    veh = cfg.vehicle
    half = veh.radius + 0.0
    seg_f = bar = seg_i = table = origin = None
    lane_off = lane_hw = lane_rows = None
    G, span, Hp, Wp, wide, cell = 0, 0, 0, 0, 0, 0.0
    h = lb = rb = kappa0 = 0.0
    if spec is not None:
        seg_f, bar, seg_i = spec_operands(spec, half, dtype, dev)
        n_rows, G = int(spec.n), seg_i.shape[0]
        h, lb, rb, kappa0 = (float(spec.h), float(spec.lb), float(spec.rb),
                             float(spec.kappa0))
    else:
        n_rows = packed.shape[1]
        if rows is not None:
            lane_rows = _lanes(rows, B, "rows")
    if mode != SPEC:
        span = grid.span
        if isinstance(grid, LaneGrid):
            lane_off = _lanes(grid.offset, B, "offset")
            lane_hw = _lanes(grid.hw, B, "hw")
        else:
            H = grid.integral.shape[0] - 1
            W = grid.integral.shape[1] - 1
            Hp, Wp = H + 2 * (span + 2), W + 2 * (span + 2)
        wd = torch.promote_types(dtype, grid.origin.dtype)
        wide = int(wd == torch.float64 and dtype == torch.float32)
        origin = grid.origin.to(wd).contiguous()
        table = grid.dilated.contiguous()
        cell = float(grid.cell)
    dims = (ctypes.c_int * 14)(B, NT, NS, NL, KS, KD, TK, mode, n_rows, G,
                               span, Hp, Wp, wide)
    consts = (ctypes.c_double * 18)(
        cfg.tf / NT, veh.width / 2 * 1.5, 1e-3, half, veh.r2x, veh.f2x,
        dp.w_obstacle, dp.w_lateral, dp.w_lateral_change,
        dp.w_lateral_velocity_change, dp.w_longitudinal_velocity_bias,
        dp.w_longitudinal_velocity_change, dp.nominal_velocity, h, lb, rb,
        kappa0, cell)
    kw = dict(dtype=dtype, device=dev)
    outs = (torch.empty((NT, B, P), **kw), torch.empty((NT, B, P), **kw),
            torch.empty((NT, B, P), dtype=torch.int64, device=dev),
            torch.empty((NT, B, P), dtype=torch.int64, device=dev))
    # the tensors stay referenced here until the launch has been queued
    ptrs = (ctypes.c_void_p * 18)(*(_ptr(v) for v in (
        s0, l0, station, sslab, dslab, None if spec is not None else packed,
        seg_f, seg_i, bar, table, origin) + outs + (lane_off, lane_hw,
                                                    lane_rows)))
    lib = _build.library()
    fn = lib.dp_sweep_f32 if dtype == torch.float32 else lib.dp_sweep_f64
    err = fn(dims, consts, ptrs,
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "dp_sweep")
    profiling.tally("dp_sweep.launches")
    profiling.tally(f"dp_sweep.width.{B}")
    if mode != SPEC and profiling.active():
        if lane_off is None:
            profiling.count("dp_sweep.roads", 1)
        else:
            seen = torch.zeros(grid.n_roads, dtype=torch.bool, device=dev)
            profiling.count("dp_sweep.roads", seen.index_fill_(
                0, grid.roads, True))
    return outs


def _lanes(v, B, name):
    """A per-scenario int64 operand, [B] or [B, 2], contiguous."""
    if v.shape[0] != B or v.dtype != torch.int64:
        raise ValueError(f"dp_sweep: {name} is {v.dtype} of shape "
                         f"{tuple(v.shape)}, expected int64 with {B} rows")
    return v.contiguous()


