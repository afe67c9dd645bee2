"""Fused corridor + lane cost stack: the CUDA kernel ``csrc/coststack.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernel
``cilqr_tpu/pallas/coststack.py::corridor_lane_stack``. Per (knot, lane),
over the D disc centres (x + off*cos(theta), y + off*sin(theta)):

* relax-barrier values over the masked corridor half-planes;
* per lane side: point-segment distances to the knot's window of W lane
  segments (sqrt form, not hypot), the nearest by first index (masked slots
  read +inf; all masked falls back to slot 0), the window-edge clip flag,
  and the barrier of the selected plane;
* with ``want_derivs``: the x/y/theta Jacobian rows and the 6
  upper-triangle Hessian entries, including the theta-theta
  ``hddx * ddx22`` term.

The constraint operands (``StackOperands``) hold each side's lane segments
once, un-windowed, with each knot's window start; ``solver_blast.cons_to_bl``
builds them once per solve round, contiguous and in the working type, so a
launch casts and copies nothing. The Pallas kernel took per-knot window
copies instead (gather-free blocks); ``window_lanes`` forms them, and the
plain version is their gather followed by the windowed math
(``corridor_lane_stack_windowed``), bit for bit what it computes on
``cons_to_bl``'s windowed tensors.

Relax barrier and windowed lanes only (solver_blast._use_coststack_kernel
gates the rest). ``corridor_lane_stack`` launches the kernel for a CUDA
tensor and runs ``corridor_lane_stack_ref`` for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import profiling
from . import _build

MAX_DISCS = 8  # csrc/coststack.cu: MAX_D


def _relax_value(g, t, eps):
    rt = 1.0 / t
    safe = torch.clamp(g, max=-eps)
    logb = -rt * torch.log(-safe)
    quadb = 0.5 * rt * (((-g - 2.0 * eps) / eps) ** 2 - 1.0) \
        - rt * math.log(eps)
    return torch.where(g < -eps, logb, quadb)


def _relax_grad(g, t, eps):
    rt = 1.0 / t
    safe = torch.clamp(g, max=-eps)
    logb = -rt / safe
    quadb = rt * (g + 2.0 * eps) / (eps * eps)
    return torch.where(g < -eps, logb, quadb)


def _relax_hess(g, t, eps):
    rt = 1.0 / t
    safe = torch.clamp(g, max=-eps)
    log_dxdx = rt / (safe * safe)
    log_ddx = -rt / safe
    quad_dxdx = rt * (g + 2.0 * eps) / (eps * eps)
    in_log = g < -eps
    return (torch.where(in_log, log_dxdx, quad_dxdx),
            torch.where(in_log, log_ddx, torch.zeros_like(g)))


class StackOperands(NamedTuple):
    """The kernel's constraint operands, contiguous, in the working type."""

    corr: torch.Tensor    # [4, N, KC, B]: corridor a, b, c and mask (0/1)
    segs: torch.Tensor    # [2, 8, S, B]: per side a, b, c, x1, y1, x2, y2
                          # and mask (0/1) of every lane segment
    start: torch.Tensor   # [2, N, B] int32: each knot's window start
    edge: torch.Tensor    # [2, 2, N, B]: per side lo, hi (0/1): segments
                          # exist beyond the window's first, last slot
    W: int                # window width


def gather_windows(row, start, W: int):
    """Each knot's window of W slots of a lane row: row [S, B], window
    starts [N, B] -> [N, W, B]."""
    N, B = start.shape
    idx = (start[:, None, :]
           + torch.arange(W, device=start.device)[None, :, None]).long()
    return torch.gather(row[None].expand(N, row.shape[0], B), 1, idx)


def window_lanes(ops: StackOperands):
    """The per-knot windows that ``ops`` implies: per side (a, b, c, x1,
    y1, x2, y2, m [N, W, B], lo, hi [N, B]), masks and flags as 0/1 in the
    working type; what ``cons_to_bl`` gathers from the same rows."""
    return tuple(tuple(gather_windows(ops.segs[s, i], ops.start[s], ops.W)
                       for i in range(8)) + (ops.edge[s, 0], ops.edge[s, 1])
                 for s in range(2))


def corridor_lane_stack_ref(xs, ops: StackOperands, offs, bt, beps,
                            want_derivs=False, want_sel=False):
    """Plain PyTorch version of the kernel: the windows ``ops`` implies,
    then the windowed math. Arguments and results as
    ``corridor_lane_stack``."""
    return corridor_lane_stack_windowed(xs, tuple(ops.corr.unbind(0)),
                                        window_lanes(ops), offs, bt, beps,
                                        want_derivs, want_sel)


def corridor_lane_stack_windowed(xs, cbl_c, lanes, offs, bt, beps,
                                 want_derivs=False, want_sel=False):
    """The kernel's math on per-knot windows (``cons_to_bl``'s windowed
    lanes, or ``window_lanes``), with its formulas (sqrt distance, masks
    as floats compared with 0.5), vectorized over every (knot, lane) at
    once. cbl_c = (ca, cb, cc, cm [N, KC, B]); lanes per side (a, b, c, x1,
    y1, x2, y2, m [N, W, B], lo, hi [N, B]; W may differ by side), masks
    bool or 0/1."""
    dtype = xs.dtype
    ca, cb, cc, cm = cbl_c
    cmb = cm.to(dtype) > 0.5                              # [N, KC, B]
    x, y, th = xs[0], xs[1], xs[2]                        # [N, B]
    ct = torch.cos(th)
    st = torch.sin(th)
    zero = torch.zeros_like(x)
    fz = torch.zeros((), dtype=dtype, device=xs.device)
    big = torch.tensor(math.inf, dtype=dtype, device=xs.device)
    corr, lane, clip = zero, zero, zero
    jx0 = jx1 = jx2 = h00 = h01 = h02 = h11 = h12 = h22 = zero
    sels = []

    for off in offs:
        lcd = off * ct                                    # [N, B]
        lsd = off * st
        cxd = x + lcd
        cyd = y + lsd

        g = ca * cxd[:, None] + cb * cyd[:, None] - cc    # [N, KC, B]
        val = torch.where(cmb, _relax_value(g, bt, beps), fz)
        corr = corr + val.sum(1)
        if want_derivs:
            dthk = -ca * lsd[:, None] + cb * lcd[:, None]
            gf = torch.where(cmb, _relax_grad(g, bt, beps), fz)
            hf, hddx = _relax_hess(g, bt, beps)
            hf = torch.where(cmb, hf, fz)
            hddx = torch.where(cmb, hddx, fz)
            ddx22 = -ca * lcd[:, None] - cb * lsd[:, None]
            jx0 = jx0 + (gf * ca).sum(1)
            jx1 = jx1 + (gf * cb).sum(1)
            jx2 = jx2 + (gf * dthk).sum(1)
            h00 = h00 + (hf * ca * ca).sum(1)
            h01 = h01 + (hf * ca * cb).sum(1)
            h02 = h02 + (hf * ca * dthk).sum(1)
            h11 = h11 + (hf * cb * cb).sum(1)
            h12 = h12 + (hf * cb * dthk).sum(1)
            h22 = h22 + (hf * dthk * dthk + hddx * ddx22).sum(1)

        for (a, b, c, x1, y1, x2, y2, m, lo, hi) in lanes:
            abx = x2 - x1                                 # [N, W, B]
            aby = y2 - y1
            apx = cxd[:, None] - x1
            apy = cyd[:, None] - y1
            ab2 = abx * abx + aby * aby
            tpar = torch.where(
                ab2 > 0, (apx * abx + apy * aby)
                / torch.where(ab2 == 0, torch.ones_like(ab2), ab2), fz)
            tpar = torch.clamp(tpar, 0.0, 1.0)
            dx = cxd[:, None] - (x1 + tpar * abx)
            dy = cyd[:, None] - (y1 + tpar * aby)
            dist = torch.sqrt(dx * dx + dy * dy)
            dist = torch.where(m.to(dtype) > 0.5, dist, big)
            W = dist.shape[1]
            iota_w = torch.arange(W, device=xs.device)[None, :, None]
            dmin = dist.amin(1, keepdim=True)
            idx = torch.where(dist == dmin, iota_w, W).amin(1)   # [N, B]
            sels.append(idx)
            sel = idx[:, None]
            la = torch.gather(a, 1, sel)[:, 0]
            lb = torch.gather(b, 1, sel)[:, 0]
            lcc = torch.gather(c, 1, sel)[:, 0]
            edge = (((idx == 0) & (lo.to(dtype) > 0.5))
                    | ((idx == W - 1) & (hi.to(dtype) > 0.5)))
            clip = torch.maximum(clip, edge.to(dtype))

            lg = la * cxd + lb * cyd - lcc
            lane = lane + _relax_value(lg, bt, beps)
            if want_derivs:
                ldth = -la * lsd + lb * lcd
                lgf = _relax_grad(lg, bt, beps)
                lhf, lhd = _relax_hess(lg, bt, beps)
                lddx22 = -la * lcd - lb * lsd
                jx0 = jx0 + lgf * la
                jx1 = jx1 + lgf * lb
                jx2 = jx2 + lgf * ldth
                h00 = h00 + lhf * la * la
                h01 = h01 + lhf * la * lb
                h02 = h02 + lhf * la * ldth
                h11 = h11 + lhf * lb * lb
                h12 = h12 + lhf * lb * ldth
                h22 = h22 + lhf * ldth * ldth + lhd * lddx22

    out = (corr, lane, clip)
    if want_derivs:
        out += (jx0, jx1, jx2, h00, h01, h02, h11, h12, h22)
    if want_sel:   # [2, D, N, B]: side, disc
        out += (torch.stack(sels).unflatten(0, (len(offs), 2)).transpose(0, 1)
                .to(torch.int32),)
    return out


def corridor_lane_stack(xs, ops: StackOperands, offs, bt, beps,
                        want_derivs=False, want_sel=False):
    """Fused corridor+lane stack rows for every (knot, lane).

    xs:     [6, N, B] batch-last states (any strides, lanes contiguous).
    ops:    ``StackOperands`` from ``solver_blast.cons_to_bl``.
    offs:   tuple of D disc offsets (Python floats).

    Returns (corr, lane, clip [N, B], clip as 0/1 floats) and, with
    want_derivs, (jx0, jx1, jx2, h00, h01, h02, h11, h12, h22 [N, B]);
    with want_sel, last, the selected window slot of every side, disc and
    (knot, lane), sel [2, D, N, B] int32 (for checks).
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. Any B is accepted: the kernel masks the ragged last tile.
    """
    if xs.device.type != "cuda":
        return corridor_lane_stack_ref(xs, ops, offs, bt, beps, want_derivs,
                                       want_sel)
    _check_operands(xs, ops, offs)
    return _launch(xs, ops, offs, bt, beps, want_derivs, want_sel)


def _check_operands(xs, ops: StackOperands, offs) -> None:
    """Raise unless the kernel takes (xs, ops, offs) as they are: it casts
    and copies nothing."""
    dtype = xs.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"corridor_lane_stack: unsupported dtype {dtype}")
    if not isinstance(ops, StackOperands):
        raise ValueError("corridor_lane_stack: ops must be the StackOperands "
                         "of cons_to_bl (lane_window > 0)")
    D = len(offs)
    if not 0 < D <= MAX_DISCS:
        raise ValueError(f"corridor_lane_stack: {D} discs, at most "
                         f"{MAX_DISCS} supported")
    if xs.dim() != 3 or xs.shape[0] != 6 or xs.stride(2) != 1:
        raise ValueError(f"corridor_lane_stack: xs has shape "
                         f"{tuple(xs.shape)} and strides {xs.stride()}, "
                         f"expected (6, N, B) with the lane axis contiguous")
    N, B = xs.shape[1], xs.shape[2]
    KC, S = ops.corr.shape[2], ops.segs.shape[2]
    if not 0 < ops.W <= S:
        raise ValueError(f"corridor_lane_stack: window {ops.W} of {S} "
                         f"segments")
    expect = {"corr": ((4, N, KC, B), dtype), "segs": ((2, 8, S, B), dtype),
              "start": ((2, N, B), torch.int32),
              "edge": ((2, 2, N, B), dtype)}
    for name, (shape, want) in expect.items():
        v = getattr(ops, name)
        if tuple(v.shape) != shape or v.dtype != want \
                or v.device != xs.device or not v.is_contiguous():
            raise ValueError(
                f"corridor_lane_stack: {name} is {tuple(v.shape)} {v.dtype} "
                f"on {v.device}, expected {shape} {want} on {xs.device}, "
                f"contiguous")


def _launch(xs, ops: StackOperands, offs, bt, beps, want_derivs,
            want_sel=False):
    """Launch csrc/coststack.cu on checked operands; returns the rows as
    ``corridor_lane_stack`` does."""
    N, B = xs.shape[1], xs.shape[2]
    KC, S, D = ops.corr.shape[2], ops.segs.shape[2], len(offs)
    dtype = xs.dtype
    n_out = 12 if want_derivs else 3
    out = torch.empty((n_out, N, B), dtype=dtype, device=xs.device)
    sel = torch.empty((2, D, N, B), dtype=torch.int32, device=xs.device) \
        if want_sel else None
    ptrs = (ctypes.c_void_p * 5)(*(v.data_ptr() for v in (
        xs, ops.corr, ops.segs, ops.start, ops.edge)))
    offs_c = (ctypes.c_double * D)(*(float(o) for o in offs))
    lib = _build.library()
    fn = lib.corridor_lane_stack_f32 if dtype == torch.float32 \
        else lib.corridor_lane_stack_f64
    err = fn(N, B, KC, S, ops.W, D, xs.stride(0), xs.stride(1),
             ctypes.cast(offs_c, ctypes.c_void_p),
             float(bt), float(beps), int(bool(want_derivs)),
             ctypes.cast(ptrs, ctypes.c_void_p),
             ctypes.c_void_p(out.data_ptr()),
             ctypes.c_void_p(0 if sel is None else sel.data_ptr()),
             ctypes.c_void_p(torch.cuda.current_stream(xs.device)
                             .cuda_stream))
    _build.check(err, "corridor_lane_stack")
    profiling.tally("corridor_lane_stack.launches")
    profiling.tally(f"corridor_lane_stack.width.{B}")
    return tuple(out.unbind(0)) + ((sel,) if want_sel else ())



def sqrt_fast_check(device="cuda"):
    """Hold the kernel's float square root without its slow-path branch
    (``sqrt_fast`` in csrc/coststack.cu) to the correctly rounded square
    root on all 2^32 float bit patterns, on the card: returns (the inputs
    it takes, those of them on which it differs). The lane selection is
    exact only if the second is 0."""
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    err = _build.library().coststack_sqrt_check(
        ctypes.c_void_p(counts.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(counts.device).cuda_stream))
    _build.check(err, "coststack_sqrt_check")
    taken, differ = (int(v) for v in counts.cpu())
    return taken, differ
