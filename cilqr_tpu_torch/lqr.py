"""Discrete-time LQR / DARE solver (PyTorch counterpart of
cilqr_tpu/lqr.py).

math::SolveLQRProblem (linear_quadratic_regulator.cc:30-79): the
fixed-point Riccati iteration with an optional cross term M, batched over
leading axes. Each problem iterates until its own stop test holds and then
freezes, as a vmapped ``lax.while_loop`` does; the host looks at the stop
tests only every CHECK_EVERY iterations, so that a batch on the card pays
one device sync per that many iterations and not one per iteration (a
frozen problem's extra iterations change nothing).
"""

from __future__ import annotations

import torch


def _inv(M):
    """Inverse over leading axes; 1x1 as a reciprocal (no solver launch,
    no error check that syncs the device)."""
    if M.shape[-1] == 1:
        return 1.0 / M
    return torch.linalg.inv_ex(M)[0]


# the host reads the stop tests once every this many iterations
CHECK_EVERY = 8


def riccati_fixed_point(A, B, Q, R, M, tolerance, max_iter):
    """The fixed-point Riccati iteration of SolveLQRProblem
    (linear_quadratic_regulator.cc:44-57) from P0 = Q, per problem until
    ``max_iter`` iterations or |max(P_next - P)| <= tolerance. A [..., n, n],
    B [..., n, m], M [..., n, m]; Q, R broadcast. Returns (P, the
    iterations each problem ran, [...] int32)."""
    n = A.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2], Q.shape[:-2],
                                   R.shape[:-2], M.shape[:-2])
    dtype, device = A.dtype, A.device
    AT, BT, MT = A.mT, B.mT, M.mT
    P = Q.expand(batch + (n, n))
    it = torch.zeros(batch, dtype=torch.int32, device=device)
    diff = torch.full(batch, torch.finfo(dtype).max, dtype=dtype,
                      device=device)
    for k in range(max_iter):
        active = (it < max_iter) & (diff > tolerance)
        if k % CHECK_EVERY == 0 and not bool(active.any()):
            break
        APB = AT @ P @ B + M
        inv = _inv(R + BT @ P @ B)
        P_next = AT @ P @ A - APB @ inv @ (BT @ P @ A + MT) + Q
        # reference quirk: |max coefficient| of the difference, NOT the
        # max |coefficient| (linear_quadratic_regulator.cc:54)
        d = (P_next - P).amax(dim=(-2, -1)).abs()
        P = torch.where(active[..., None, None], P_next, P)
        diff = torch.where(active, d, diff)
        it = it + active.to(torch.int32)
    return P, it


def solve_lqr(A, B, Q, R, tolerance=0.01, max_iter=150, M=None):
    """The gain K minimizing sum x'Qx + u'Ru (+ 2 x'Mu) for
    x_{k+1} = A x_k + B u_k, u = -K x. A [..., n, n], B [..., n, m]; Q, R
    and M broadcast against them."""
    if M is None:
        M = torch.zeros(A.shape[:-1] + B.shape[-1:], dtype=A.dtype,
                        device=A.device)
    P, _ = riccati_fixed_point(A, B, Q, R, M, tolerance, max_iter)
    return _inv(R + B.mT @ P @ B) @ (B.mT @ P @ A + M.mT)
