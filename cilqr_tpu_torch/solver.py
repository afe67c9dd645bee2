"""Initial guess and goal transform of the CILQR solve (PyTorch
counterpart of the batched-solve half of cilqr_tpu/solver.py).

Batched over a leading axis B. The single-problem ``solve``,
``solve_with_history`` and the backward/forward passes of the vmap
backend are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

from .config import IlqrConfig, VehicleParam
from .model import dynamics_jacobian, dynamics_rk2


def transform_goals(coarse_xs, start_state):
    """TransformGoals (ilqr_optimizer.cc:141-152): goals are the coarse
    states, with goal[0] overwritten by the actual start state
    (x, y, theta, v, 0, 0). coarse_xs [B, N, 6], start_state [B, >=4]."""
    g0 = torch.cat([start_state[:, :4],
                    torch.zeros_like(start_state[:, :2])], dim=-1)
    return torch.cat([g0[:, None], coarse_xs[:, 1:]], dim=1)


def _inv22(M):
    """Closed-form 2x2 inverse over leading axes: M [..., 2, 2]."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([
        torch.stack([d, -b], dim=-1),
        torch.stack([-c, a], dim=-1),
    ], dim=-2) * inv_det[..., None, None]


def iqr_init(goals, cfg: IlqrConfig, veh: VehicleParam, dt):
    """Time-varying LQR initial guess around the goal trajectory
    (IlqrOptimizer::iqr, ilqr_optimizer.cc:793-842): backward Riccati with
    fixed Q/R, then a clamped closed-loop rollout through the real
    dynamics. goals [B, N, 6] -> (xs [B, N, 6], us [B, N-1, 2])."""
    dtype, device = goals.dtype, goals.device
    B, N = goals.shape[0], goals.shape[1]
    Q = torch.diag(torch.tensor([0.001, 0.001, 0.001, 0.001, 0.01, 0.005],
                                dtype=dtype, device=device))
    R = torch.diag(torch.tensor([0.2, 0.05], dtype=dtype, device=device))

    zero_u = torch.zeros((B, N - 1, 2), dtype=dtype, device=device)
    A, Bm = dynamics_jacobian(goals[:, :-1], zero_u, dt, veh.wheel_base,
                              cfg.jacobian_mode)        # [B, T, 6, 6/2]

    P = Q.expand(B, 6, 6)
    Ks = [None] * (N - 1)
    for t in range(N - 2, -1, -1):
        Ai, Bi = A[:, t], Bm[:, t]
        BtP = Bi.transpose(1, 2) @ P
        K = _inv22(R + BtP @ Bi) @ (BtP @ Ai)
        P = Q + Ai.transpose(1, 2) @ P @ (Ai - Bi @ K)
        Ks[t] = K

    jlo = torch.tensor([veh.jerk_min, veh.delta_rate_min], dtype=dtype,
                       device=device)
    jhi = torch.tensor([veh.jerk_max, veh.delta_rate_max], dtype=dtype,
                       device=device)
    x = goals[:, 0]
    xs, us = [x], []
    for t in range(N - 1):
        u = -(Ks[t] @ (x - goals[:, t])[..., None])[..., 0]
        u = torch.minimum(torch.maximum(u, jlo), jhi)
        x = dynamics_rk2(x, u, dt, veh.wheel_base)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)
