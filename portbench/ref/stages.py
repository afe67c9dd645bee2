"""The replan's and the MPC cycle's stages around the solve, copied from the
port's ``pipeline`` and ``mpc`` modules (the same arithmetic, calling the
frozen modules of this package), and the two compositions the comparison
runs: a replan's problem (DP, corridors, constraints, goals) and an MPC
cycle's problem (the shifted plan and its corridors)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import corridor as corridor_mod
from . import dp as dp_mod
from .config import PlannerConfig
from .costs import ConstraintSet, shrink_and_normalize, trim_constraints
from .types import CorridorSet, Scenario, Traj
from .world import (build_barrier_grid, check_optimization_collision,
                    dyn_polys_at)

NEAR_TERM_KNOTS = 25


def coarse_to_states(traj: Traj):
    return torch.stack([traj.x, traj.y, traj.theta, traj.velocity, traj.a,
                        traj.delta], dim=-1)


def make_lane_tuple(left_barrier, right_barrier, cfg: PlannerConfig,
                    dtype=np.float64):
    return corridor_mod.lane_constraints(np.asarray(left_barrier),
                                         np.asarray(right_barrier),
                                         cfg.corridor, dtype)


def recheck(scns: Scenario, xs, cfg: PlannerConfig, spec, t0=None):
    """Per-knot collision mask [B, N] of trajectories xs [B, N, 6] at each
    knot's absolute time (t0 [B] the time of knot 0, None = 0)."""
    times = cfg.delta_t * torch.arange(xs.shape[-2], dtype=xs.dtype,
                                       device=xs.device)
    if t0 is not None:
        times = t0[:, None] + times
    dyn = dyn_polys_at(scns, times)
    return check_optimization_collision(
        scns, xs[..., 0], xs[..., 1], xs[..., 2], cfg.vehicle.radius,
        cfg.vehicle.r2x, cfg.vehicle.f2x, collision_buffer=0.0,
        mode="frenet" if spec is not None else "exact", road_spec=spec,
        dyn_polys=dyn)


def prep_constraints(cors: CorridorSet, cfg: PlannerConfig) -> ConstraintSet:
    return trim_constraints(shrink_and_normalize(
        cors.planes, cors.plane_mask, cors.left_planes, cors.left_segs,
        cors.left_mask, cors.right_planes, cors.right_segs, cors.right_mask,
        cfg.ilqr, cfg.vehicle))


def road_grid(barrier_xy, cfg: PlannerConfig):
    return build_barrier_grid(barrier_xy, cfg.dp.grid_cell,
                              half=cfg.vehicle.radius,
                              dtype=barrier_xy.dtype,
                              device=barrier_xy.device)


def start_states(starts, dtype):
    starts = starts.to(dtype)
    return torch.cat([starts, torch.zeros_like(starts[:, :2])], dim=-1)


def shift_plan(xs, us):
    return (torch.cat([xs[..., 1:, :], xs[..., -1:, :]], dim=-2),
            torch.cat([us[..., 1:, :], us[..., -1:, :]], dim=-2))


class Problem(NamedTuple):
    """What the solve of a replan or a cycle is given, worked out from the
    inputs: goals [B, N, 6], starts [B, 6], constraints, the corridors, the
    warm start (None for the LQR guess) and the time of knot 0 (None = 0);
    for a replan also the DP's coarse trajectory and its ok flags."""

    goals: torch.Tensor
    starts: torch.Tensor
    cons: ConstraintSet
    corridors: CorridorSet
    warm: tuple | None
    t0: torch.Tensor | None
    coarse: Traj | None
    dp_ok: torch.Tensor | None


def replan_problem(scns: Scenario, starts, cfg: PlannerConfig, lane,
                   spec=None) -> Problem:
    """DP -> corridors -> constraints of a replan (the DP's grid built from
    the first scenario's barriers in grid mode)."""
    grid = None
    if cfg.dp.collision_mode == "grid":
        grid = road_grid(scns.barrier_xy[0], cfg)
    d = dp_mod.plan(scns, starts[:, 0], starts[:, 1], starts[:, 2], cfg,
                    grid, spec=spec)
    cors = corridor_mod.plan_corridors(scns, d.traj, cfg.corridor, lane)
    goals = coarse_to_states(d.traj)
    return Problem(goals=goals, starts=start_states(starts, goals.dtype),
                   cons=prep_constraints(cors, cfg), corridors=cors,
                   warm=None, t0=None, coarse=d.traj, dp_ok=d.ok)


def cycle_problem(scns: Scenario, xs, us, cycle_time, cfg: PlannerConfig,
                  lane) -> Problem:
    """The problem of one MPC cycle from the plan it is handed: the plan
    shifted one knot, the corridors at the new absolute times."""
    goals, warm_us = shift_plan(xs, us)
    t_new = cycle_time + cfg.delta_t
    B, n = goals.shape[0], goals.shape[1]
    times = t_new[:, None] + cfg.delta_t * torch.arange(
        n, dtype=goals.dtype, device=goals.device)
    pred = Traj.zeros((B, n), goals.dtype, goals.device).replace(
        x=goals[..., 0], y=goals[..., 1], theta=goals[..., 2], time=times)
    cors = corridor_mod.plan_corridors(scns, pred, cfg.corridor, lane)
    return Problem(goals=goals, starts=goals[:, 0],
                   cons=prep_constraints(cors, cfg), corridors=cors,
                   warm=(goals, warm_us), t0=t_new, coarse=None, dp_ok=None)
