"""LQR path/speed tracker, the reference's alternative initial guess
(PyTorch counterpart of cilqr_tpu/tracker.py).

Tracker (tracker.{h,cc}): a decoupled lateral/longitudinal LQR tracking
simulation at 0.01 s that yields a dynamically feasible trajectory along a
coarse plan, batched over vehicles (a leading axis B). It keeps the
reference's substep bookkeeping exactly (see ``plan``) and, as the JAX
package does, solves the constant longitudinal DARE once instead of every
substep (the same iteration from the same P0 = Q, so the same gain).

The 801 substeps run as a host loop; each substep's lateral DARE is a
per-vehicle fixed point (lqr.solve_lqr), frozen per vehicle at its own
stopping iteration.
"""

from __future__ import annotations

import torch

from .config import TrackerConfig, VehicleParam
from .geometry import normalize_angle
from .lqr import solve_lqr
from .reference_line import evaluate_time, get_projection
from .types import Traj


def _diag(vals, dtype, device):
    return torch.diag(torch.tensor(vals, dtype=dtype, device=device))


def _lat_lqr_gain(v, cfg: TrackerConfig, veh: VehicleParam, dtype=None):
    """Lateral gains [B, 1, 3] for speeds v [B] (Tracker::LateralControl,
    tracker.cc:55-70): state (l, theta_err, delta), control delta_rate."""
    dtype = dtype or v.dtype
    v_amend = torch.clamp(v.to(dtype), min=2.0)
    dt = cfg.dt
    A = torch.eye(3, dtype=dtype, device=v.device).repeat(v.shape + (1, 1))
    A[..., 0, 1] = v_amend * dt
    A[..., 1, 2] = -v_amend / veh.wheel_base * dt
    B = torch.zeros((3, 1), dtype=dtype, device=v.device)
    B[2, 0] = dt
    Q = _diag([cfg.lat_weight_l, cfg.lat_weight_theta,
               cfg.lat_weight_delta], dtype, v.device)
    R = torch.tensor([[cfg.lat_weight_delta_rate]], dtype=dtype,
                     device=v.device)
    return solve_lqr(A, B, Q, R, cfg.tolerance, cfg.max_num_iteration)


def _lon_lqr_gain(cfg: TrackerConfig, dtype, device):
    """Longitudinal gain [1, 3] (Tracker::LongitudinalControl + InitMatrix,
    tracker.cc:72-81,138-167): state (s_err, v_err, a), control jerk."""
    dt = cfg.dt
    A = torch.eye(3, dtype=dtype, device=device)
    A[0, 1] = dt
    A[1, 2] = -dt
    B = torch.zeros((3, 1), dtype=dtype, device=device)
    B[2, 0] = dt
    Q = _diag([cfg.lon_weight_s, cfg.lon_weight_v, cfg.lon_weight_a], dtype,
              device)
    R = torch.tensor([[cfg.lon_weight_j]], dtype=dtype, device=device)
    return solve_lqr(A, B, Q, R, cfg.tolerance, cfg.max_num_iteration)


def plan(start_state, coarse: Traj, cfg: TrackerConfig, veh: VehicleParam):
    """Tracker::Plan / lqr (tracker.cc:12-17,169-215) for a batch.
    start_state [B, 6] (x, y, theta, v, a, delta); coarse: Traj of [B, N]
    fields. Returns (xs [B, N, 6], us [B, N-1, 2]) on the coarse
    trajectories' 0.1 s knots.

    The reference's bookkeeping (tracker.cc:184-203), kept exactly: the
    loop runs t from the start time to the end time INCLUSIVE (801
    iterations); the state produced at loop time t is labeled time t (:198,
    one substep behind its true time), so the longitudinal match point lags
    one substep; knot k is pushed when the label reaches 0.1k (the end of
    iteration j = 10k, the state after 10k+1 integrations) and its stored
    controls are those computed at iteration j = 10(k+1) (:194-195)."""
    dtype = coarse.x.dtype
    n_knots = coarse.x.shape[-1]
    sub = int(round(cfg.dt / cfg.simulation_dt))       # 10
    n_steps = (n_knots - 1) * sub + 1                  # 801: t in [0, 8.0]
    sdt = cfg.simulation_dt
    L = veh.wheel_base
    K_lon = _lon_lqr_gain(cfg, dtype, coarse.x.device)[0]     # [3]

    def deriv(x, jerk, delta_rate):
        """vehicle_mode (tracker.h:72-87): state (x, y, theta, v, a, delta)."""
        return torch.stack([
            x[..., 3] * torch.cos(x[..., 2]),
            x[..., 3] * torch.sin(x[..., 2]),
            x[..., 3] * torch.tan(x[..., 5]) / L,
            x[..., 4],
            jerk,
            delta_rate,
        ], dim=-1)

    def rk4(x, jerk, delta_rate):
        """VehicleDynamic (tracker.cc:83-136), with its clamps."""
        k1 = deriv(x, jerk, delta_rate)
        k2 = deriv(x + 0.5 * sdt * k1, jerk, delta_rate)
        k3 = deriv(x + 0.5 * sdt * k2, jerk, delta_rate)
        k4 = deriv(x + sdt * k3, jerk, delta_rate)
        nxt = x + sdt * (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
        return torch.stack([
            nxt[..., 0], nxt[..., 1], normalize_angle(nxt[..., 2]),
            torch.clamp(nxt[..., 3], min=0.0),
            torch.clamp(nxt[..., 4], veh.min_acceleration,
                        veh.max_acceleration),
            normalize_angle(torch.clamp(nxt[..., 5], veh.delta_min,
                                        veh.delta_max)),
        ], dim=-1)

    def control(x, t):
        """CalcaulateInitState + both LQR controls (tracker.cc:19-81)."""
        pv_x = x[..., 0] + torch.cos(x[..., 2]) * x[..., 3] * \
            cfg.lat_preview_time
        pv_y = x[..., 1] + torch.sin(x[..., 2]) * x[..., 3] * \
            cfg.lat_preview_time
        _, _, proj = get_projection(coarse, pv_x, pv_y)
        dx = x[..., 0] - proj.x
        dy = x[..., 1] - proj.y
        l = torch.sin(proj.theta) * dx - torch.cos(proj.theta) * dy
        theta_err = normalize_angle(proj.theta - x[..., 2])
        lat_state = torch.stack([l, theta_err, x[..., 5]], dim=-1)

        match = evaluate_time(coarse, t)
        lon_state = torch.stack([match.s - proj.s,
                                 match.velocity - x[..., 3], x[..., 4]],
                                dim=-1)

        K_lat = _lat_lqr_gain(x[..., 3], cfg, veh, dtype)       # [B, 1, 3]
        delta_rate = -(K_lat @ lat_state[..., None])[..., 0, 0]
        jerk = -(K_lon @ lon_state[..., None])[..., 0]
        delta_rate = torch.clamp(delta_rate, veh.delta_rate_min,
                                 veh.delta_rate_max)
        jerk = torch.clamp(jerk, veh.jerk_min, veh.jerk_max)
        return jerk, delta_rate

    x = start_state.to(dtype)
    # t_label = the reference's cur_state.time (set to the PREVIOUS loop t
    # after integrating, tracker.cc:198); t_loop = the loop variable,
    # accumulated t += sdt exactly as the C++ does
    t_label = coarse.time[..., 0]
    t_loop = t_label
    knots, us = [x], []
    for j in range(n_steps):
        jerk, drate = control(x, t_label)
        x = rk4(x, jerk, drate)
        t_label, t_loop = t_loop, t_loop + sdt
        if j > 0 and j % sub == 0:
            # knot j/sub = the state at the end of iteration j; its
            # controls are those computed at the same iteration
            knots.append(x)
            us.append(torch.stack([jerk, drate], dim=-1))
    return torch.stack(knots, dim=-2), torch.stack(us, dim=-2)
