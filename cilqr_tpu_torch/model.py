"""Kinematic bicycle model: RK2 (midpoint) discrete dynamics + Jacobians
(PyTorch counterpart of cilqr_tpu/model.py).

State  x = [x, y, theta, v, a, delta]   (6)
Control u = [jerk, delta_rate]          (2)

``analytic`` Jacobians replicate the reference's hand-derived midpoint
scheme (vehicle_model.cc:44-86), including its quirk that A[2,5] and B[2,1]
use ``v`` where the true midpoint derivative uses ``v + 0.5*dt*a``.
"""

from __future__ import annotations

import torch

from .geometry import normalize_angle

STATE_DIM = 6
CONTROL_DIM = 2


def dynamics_continuous(state, control, wheel_base):
    """Continuous-time bicycle ODE (vehicle_model.cc:123-138). Works on
    [..., 6] / [..., 2] tensors."""
    theta = normalize_angle(state[..., 2])
    v = state[..., 3]
    a = state[..., 4]
    delta = normalize_angle(state[..., 5])
    return torch.stack([
        v * torch.cos(theta),
        v * torch.sin(theta),
        v * torch.tan(delta) / wheel_base,
        a,
        control[..., 0],
        control[..., 1],
    ], dim=-1)


def dynamics_rk2(state, control, dt, wheel_base):
    """Midpoint (RK2) discrete step with angle wrap on theta/delta
    (vehicle_model.cc:107-121)."""
    k1 = dynamics_continuous(state, control, wheel_base)
    mid = state + 0.5 * dt * k1
    k2 = dynamics_continuous(mid, control, wheel_base)
    nxt = state + dt * k2
    return torch.cat([nxt[..., :2], normalize_angle(nxt[..., 2:3]),
                      nxt[..., 3:5], normalize_angle(nxt[..., 5:6])], dim=-1)


def dynamics_jacobian_analytic(state, control, dt, wheel_base):
    """Reference-parity analytic Jacobians of the midpoint scheme
    (vehicle_model.cc:44-86). Returns (A [..., 6, 6], B [..., 6, 2])."""
    L = wheel_base
    v = state[..., 3]
    theta = normalize_angle(state[..., 2])
    delta = normalize_angle(state[..., 5])
    a = state[..., 4]
    delta_rate = control[..., 1]

    theta_mid = theta + 0.5 * dt * v * torch.tan(delta) / L
    tan_delta = torch.tan(delta)
    tan_delta_rate = torch.tan(delta + 0.5 * dt * delta_rate)
    cos_tm = torch.cos(theta_mid)
    sin_tm = torch.sin(theta_mid)
    td2 = tan_delta * tan_delta
    tdr2 = tan_delta_rate * tan_delta_rate
    v_mid = 0.5 * a * dt + v
    # the reference uses plain v (not v_mid) here (vehicle_model.cc:59,82)
    v_tdr = v * (tdr2 + 1.0)

    z = torch.zeros_like(v)
    o = torch.ones_like(v)
    A = torch.stack([
        torch.stack([o, z, -dt * v_mid * sin_tm,
                     dt * cos_tm - 0.5 * dt * dt * v_mid * sin_tm * tan_delta / L,
                     0.5 * dt * dt * cos_tm,
                     -0.5 * dt * dt * v * v_mid * (td2 + 1.0) * sin_tm / L], dim=-1),
        torch.stack([z, o, dt * v_mid * cos_tm,
                     dt * sin_tm + 0.5 * dt * dt * v_mid * cos_tm * tan_delta / L,
                     0.5 * dt * dt * sin_tm,
                     0.5 * dt * dt * v * v_mid * (td2 + 1.0) * cos_tm / L], dim=-1),
        torch.stack([z, z, o,
                     dt * tan_delta_rate / L,
                     0.5 * dt * dt * tan_delta_rate / L,
                     dt * v_tdr / L], dim=-1),
        torch.stack([z, z, z, o, dt * o, z], dim=-1),
        torch.stack([z, z, z, z, o, z], dim=-1),
        torch.stack([z, z, z, z, z, o], dim=-1),
    ], dim=-2)

    B = torch.stack([
        torch.stack([z, z], dim=-1),
        torch.stack([z, z], dim=-1),
        torch.stack([z, 0.5 * dt * dt * v * (tdr2 + 1.0) / L], dim=-1),
        torch.stack([0.5 * dt * dt * o, z], dim=-1),
        torch.stack([dt * o, z], dim=-1),
        torch.stack([z, dt * o], dim=-1),
    ], dim=-2)
    return A, B


def dynamics_jacobian(state, control, dt, wheel_base, mode: str = "analytic"):
    if mode == "analytic":
        return dynamics_jacobian_analytic(state, control, dt, wheel_base)
    if mode == "autodiff":
        raise NotImplementedError(
            "jacobian_mode='autodiff' is not ported yet (ROADMAP.md, queue 1)")
    raise ValueError(f"unknown jacobian mode {mode!r}")


def rollout(x0, us, dt, wheel_base):
    """Open-loop rollout: x0 [6], us [T, 2] -> xs [T+1, 6]."""
    xs = [x0]
    for t in range(us.shape[0]):
        xs.append(dynamics_rk2(xs[-1], us[t], dt, wheel_base))
    return torch.stack(xs)
