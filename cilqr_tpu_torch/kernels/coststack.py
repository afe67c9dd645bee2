"""Fused corridor + lane cost stack: the CUDA kernel ``csrc/coststack.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernel
``cilqr_tpu/pallas/coststack.py::corridor_lane_stack``. Per (knot, lane),
over the D disc centres (x + off*cos(theta), y + off*sin(theta)):

* relax-barrier values over the masked corridor half-planes;
* per lane side: point-segment distances to the W window segments (sqrt
  form, not hypot), the nearest by first index (masked slots read +inf; all
  masked falls back to slot 0), the window-edge clip flag, and the barrier
  of the selected plane;
* with ``want_derivs``: the x/y/theta Jacobian rows and the 6
  upper-triangle Hessian entries, including the theta-theta
  ``hddx * ddx22`` term.

Relax barrier and windowed lanes only (solver_blast._use_coststack_kernel
gates the rest). ``corridor_lane_stack`` launches the kernel for a CUDA
tensor and runs ``corridor_lane_stack_ref`` for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

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


def corridor_lane_stack_ref(xs, cbl_c, lanes, offs, bt, beps,
                            want_derivs=False):
    """Plain PyTorch version of the kernel, with its formulas (sqrt
    distance, masks as floats compared with 0.5), vectorized over every
    (knot, lane) at once. Arguments and results as ``corridor_lane_stack``."""
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
    W = lanes[0][0].shape[1]
    iota_w = torch.arange(W, device=xs.device)[None, :, None]

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
            dmin = dist.amin(1, keepdim=True)
            idx = torch.where(dist == dmin, iota_w, W).amin(1)   # [N, B]
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
    return out


def corridor_lane_stack(xs, cbl_c, lanes, offs, bt, beps,
                        want_derivs=False):
    """Fused corridor+lane stack rows for every (knot, lane).

    xs:     [6, N, B] batch-last states.
    cbl_c:  (ca, cb, cc [N, KC, B], cm [N, KC, B] bool).
    lanes:  per side (a, b, c, x1, y1, x2, y2 [N, W, B], m [N, W, B] bool,
            lo, hi [N, B] bool): the windowed form from cons_to_bl.
    offs:   tuple of D disc offsets (Python floats).

    Returns (corr, lane, clip [N, B], clip as 0/1 floats) and, with
    want_derivs, (jx0, jx1, jx2, h00, h01, h02, h11, h12, h22 [N, B]).
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. Any B is accepted: the kernel masks the ragged last block.
    """
    if xs.device.type != "cuda":
        return corridor_lane_stack_ref(xs, cbl_c, lanes, offs, bt, beps,
                                       want_derivs)
    return _launch(kernel_operands(xs, cbl_c, lanes, offs), offs, bt, beps,
                   want_derivs)


def kernel_operands(xs, cbl_c, lanes, offs):
    """The kernel's 25 operands: the inputs of ``corridor_lane_stack``
    checked, their masks cast to the working type (as in the Pallas
    wrapper), contiguous."""
    dtype = xs.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"corridor_lane_stack: unsupported dtype {dtype}")
    if len(lanes) != 2 or any(len(side) != 10 or side[8] is None
                              for side in lanes):
        raise ValueError("corridor_lane_stack: lanes must be the two "
                         "windowed sides from cons_to_bl (lane_window > 0)")
    N, B = xs.shape[1], xs.shape[2]
    ca, cb, cc, cm = cbl_c
    KC = ca.shape[1]
    W = lanes[0][0].shape[1]
    D = len(offs)
    if not 0 < D <= MAX_DISCS:
        raise ValueError(f"corridor_lane_stack: {D} discs, at most "
                         f"{MAX_DISCS} supported")
    if tuple(xs.shape) != (6, N, B):
        raise ValueError(f"corridor_lane_stack: xs has shape "
                         f"{tuple(xs.shape)}, expected (6, N, B)")
    ops = [xs, ca, cb, cc, cm.to(dtype)]
    shapes = [(6, N, B)] + [(N, KC, B)] * 4
    for side in lanes:
        a, b, c, x1, y1, x2, y2, m, lo, hi = side
        ops += [a, b, c, x1, y1, x2, y2, m.to(dtype), lo.to(dtype),
                hi.to(dtype)]
        shapes += [(N, W, B)] * 8 + [(N, B)] * 2
    for i, (v, shape) in enumerate(zip(ops, shapes)):
        if tuple(v.shape) != shape or v.dtype != dtype \
                or v.device != xs.device:
            raise ValueError(
                f"corridor_lane_stack: operand {i} is {tuple(v.shape)} "
                f"{v.dtype} on {v.device}, expected {shape} {dtype} on "
                f"{xs.device}")
    return [v.contiguous() for v in ops]


def _launch(ops, offs, bt, beps, want_derivs):
    """Launch csrc/coststack.cu on ``kernel_operands``' result; returns the
    rows as ``corridor_lane_stack`` does."""
    xs = ops[0]
    N, B, KC, W, D = xs.shape[1], xs.shape[2], ops[1].shape[1], \
        ops[5].shape[1], len(offs)
    dtype = xs.dtype
    n_out = 12 if want_derivs else 3
    out = torch.empty((n_out, N, B), dtype=dtype, device=xs.device)
    ptrs = (ctypes.c_void_p * len(ops))(*(v.data_ptr() for v in ops))
    offs_c = (ctypes.c_double * D)(*(float(o) for o in offs))
    lib = _build.library()
    fn = lib.corridor_lane_stack_f32 if dtype == torch.float32 \
        else lib.corridor_lane_stack_f64
    err = fn(N, B, KC, W, D, ctypes.cast(offs_c, ctypes.c_void_p),
             float(bt), float(beps), int(bool(want_derivs)),
             ctypes.cast(ptrs, ctypes.c_void_p),
             ctypes.c_void_p(out.data_ptr()),
             ctypes.c_void_p(torch.cuda.current_stream(xs.device)
                             .cuda_stream))
    _build.check(err, "corridor_lane_stack")
    corridor_lane_stack.launches += 1
    return tuple(out.unbind(0))


corridor_lane_stack.launches = 0
