"""Fused Riccati backward + line-search forward sweep: the CUDA kernel
``csrc/sweep.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``cilqr_tpu/pallas/sweep.py::riccati_sweep``.
Semantics (ilqr_optimizer.cc:334-415): a Levenberg-regularized Riccati
backward pass with a closed-form 2x2 gain solve, symmetrized Vxx, the dV
accumulators and gnorm of k against the current us; then KA closed-loop RK2
rollouts from xs[0], one per alpha row, all reusing the gains. Angles are
wrapped in the kernel's floor form x - 2pi*floor((x + pi) / 2pi), which is
not bit-equal to geometry.normalize_angle.

The plain version is the megakernel's backward pass and rollout step
(``kernels/megasolve.py``), and the kernel performs the same sequence of
separately rounded operations: on the card the two agree bit for bit, on
dV0, dV1, gnorm and every free-running rollout (chip_smoke.py checks it).

``riccati_sweep`` launches the kernel for a CUDA tensor and runs
``riccati_sweep_ref`` for a CPU tensor (the counterpart of the Pallas
kernel's interpret mode).
"""

from __future__ import annotations

import ctypes

import torch

from .. import profiling
from . import _build
from .megasolve import _backward, _forward_step, _step_constants


def _backward_ref(lam, A, Bm, Jx, Ju, Hx, Hu, us):
    """The kernel's backward pass: (Ks [T,2,6,B], ks [T,2,B], dV0, dV1,
    gnorm), gnorm = mean over t of max over u of |k| / (|u| + 1), against
    the current us."""
    return _backward(lam, A, Bm, Jx, Hx, Ju, Hu, us)


def _forward_step_ref(x, t, alpha, Ks, ks, xs, us, dt, wheel_base):
    """One step of the kernel's closed-loop rollout from state x [6, B]:
    returns (u [2, B], next state [6, B])."""
    return _forward_step(x, t, alpha, Ks, ks, xs, us,
                         _step_constants(dt, wheel_base))


def riccati_sweep_ref(lam, alpha, A, Bm, Jx, Ju, Hx, Hu, xs, us,
                      dt: float, wheel_base: float):
    """Plain PyTorch version of the kernel. Shapes as ``riccati_sweep``."""
    T = us.shape[0]
    stacked = alpha.dim() == 2
    alpha2 = alpha if stacked else alpha[None]
    c = _step_constants(dt, wheel_base)
    Ks, ks, dV0, dV1, gnorm = _backward_ref(lam, A, Bm, Jx, Ju, Hx, Hu, us)
    nxs_all, nus_all = [], []
    for a in range(alpha2.shape[0]):
        x = xs[0]
        nxs, nus = [x], []
        for t in range(T):
            u, x = _forward_step(x, t, alpha2[a], Ks, ks, xs, us, c)
            nxs.append(x)
            nus.append(u)
        nxs_all.append(torch.stack(nxs))
        nus_all.append(torch.stack(nus))
    if not stacked:
        return nxs_all[0], nus_all[0], dV0, dV1, gnorm
    return tuple(nxs_all), tuple(nus_all), dV0, dV1, gnorm


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def riccati_sweep(lam, alpha, A, Bm, Jx, Ju, Hx, Hu, xs, us,
                  dt: float, wheel_base: float):
    """Fused backward+forward sweep over a batch (batch axis last).

    lam [B]; alpha [B] or [KA, B]; A [T,6,6,B]; Bm [T,6,2,B]; Jx [N,6,B];
    Ju [T,2,B]; Hx [N,6,6,B]; Hu [T,2,2,B]; xs [N,6,B] (knot-major);
    us [T,2,B]. alpha [B] returns (nxs [N,6,B], nus [T,2,B], dV0, dV1,
    gnorm); alpha [KA, B] runs one backward pass and KA rollouts and
    returns (KA-tuple of nxs, KA-tuple of nus, dV0, dV1, gnorm).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. Any B is accepted: the kernel masks the ragged last block.
    """
    if lam.device.type != "cuda":
        return riccati_sweep_ref(lam, alpha, A, Bm, Jx, Ju, Hx, Hu, xs, us,
                                 dt, wheel_base)
    T = us.shape[0]
    N = T + 1
    B = lam.shape[0]
    stacked = alpha.dim() == 2
    alpha2 = alpha if stacked else alpha[None]
    KA = alpha2.shape[0]
    dtype = lam.dtype
    expect = {"lam": (B,), "alpha": (KA, B), "A": (T, 6, 6, B),
              "Bm": (T, 6, 2, B), "Jx": (N, 6, B), "Ju": (T, 2, B),
              "Hx": (N, 6, 6, B), "Hu": (T, 2, 2, B), "xs": (N, 6, B),
              "us": (T, 2, B)}
    ins = dict(lam=lam, alpha=alpha2, A=A, Bm=Bm, Jx=Jx, Ju=Ju, Hx=Hx,
               Hu=Hu, xs=xs, us=us)
    for name, v in ins.items():
        if tuple(v.shape) != expect[name]:
            raise ValueError(f"riccati_sweep: {name} has shape "
                             f"{tuple(v.shape)}, expected {expect[name]}")
        if v.dtype != dtype or v.device != lam.device:
            raise ValueError(f"riccati_sweep: {name} is {v.dtype} on "
                             f"{v.device}, expected {dtype} on {lam.device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"riccati_sweep: unsupported dtype {dtype}")
    ins = {k: v.contiguous() for k, v in ins.items()}
    kw = dict(dtype=dtype, device=lam.device)
    nxs = torch.empty((KA, N, 6, B), **kw)
    nus = torch.empty((KA, T, 2, B), **kw)
    dv = torch.empty((3, B), **kw)
    lib = _build.library()
    fn = lib.riccati_sweep_f32 if dtype == torch.float32 \
        else lib.riccati_sweep_f64
    err = fn(T, B, KA, float(dt), float(wheel_base),
             *(_ptr(v) for v in ins.values()),
             _ptr(nxs), _ptr(nus), _ptr(dv[0]), _ptr(dv[1]), _ptr(dv[2]),
             ctypes.c_void_p(torch.cuda.current_stream(lam.device)
                             .cuda_stream))
    _build.check(err, "riccati_sweep")
    profiling.tally("riccati_sweep.launches")
    profiling.tally(f"riccati_sweep.width.{B}")
    if not stacked:
        return nxs[0], nus[0], dv[0], dv[1], dv[2]
    return tuple(nxs.unbind(0)), tuple(nus.unbind(0)), dv[0], dv[1], dv[2]

