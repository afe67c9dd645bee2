"""The full replan (PyTorch counterpart of cilqr_tpu/pipeline.py's batched
path): DP coarse search -> safe corridors -> constraint prep -> batched
CILQR solve -> per-knot collision re-check -> repair ladder.

``plan_batch`` is the replan step the JAX package's pipeline benchmark
times (the reference's per-cycle DP -> corridor -> iLQR sequence,
trajectory_planner.cpp:28-94, for a batch of scenarios). Its tensors stay
on the device of the scenarios it is given; the repair ladder's rounds are
host branches on whether any lane is dirty (the JAX package's
``lax.cond``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import corridor as corridor_mod
from . import dp as dp_mod
from .batch import solve_batch
from .config import PlannerConfig
from .costs import (ConstraintSet, shrink_and_normalize, tighten_constraints,
                    total_cost, trim_constraints)
from .geometry import hypot, normalize_angle
from .solver import transform_goals
from .types import (CorridorSet, Scenario, SolveResult, SolverStatus, Traj,
                    _Fields)
from .world import check_optimization_collision, dyn_polys_at

# knots of the re-checked "executed" horizon (2.5 s at delta_t=0.1): the
# far-tail residual violations start at knot >= ~30, so a clean [0, 25)
# prefix is the safety gate for the part of the plan a receding-horizon
# deployment executes before replanning
NEAR_TERM_KNOTS = 25


@dataclasses.dataclass
class PlanOutput(_Fields):
    """What a replan returns, every field with the batch axis leading.

    solve: the FINAL emitted solve (a repaired lane's is its repair
    re-solve); ok: dp_ok & every corridor knot ok; solve_hits [B, N]: the
    two-disc re-check of the final trajectory at each knot's time;
    pre_hits: the re-check of the original solve, before the repair;
    repaired: the lane was near-term dirty and a repair round's converged,
    clean re-solve replaced it; still_dirty: the final near-term horizon
    still re-checks dirty (the caller must not execute that plan)."""

    coarse: Traj
    dp_ok: torch.Tensor
    corridors: CorridorSet
    solve: SolveResult
    ok: torch.Tensor
    solve_hits: torch.Tensor
    pre_hits: torch.Tensor
    repaired: torch.Tensor
    still_dirty: torch.Tensor


def coarse_to_states(traj: Traj):
    """Coarse trajectory -> [..., N, 6] goal states (TransformGoals input,
    ilqr_optimizer.cc:147-149)."""
    return torch.stack([traj.x, traj.y, traj.theta, traj.velocity, traj.a,
                        traj.delta], dim=-1)


def traj_from_solution(xs, us, dt, wheel_base) -> Traj:
    """TransformToTrajectory + final resampling (ilqr_optimizer.cc:771-791,
    trajectory_planner.cpp:100-125): kappa = tan(delta)/L, accumulated s.
    xs [..., N, 6], us [..., N-1, 2]."""
    n = xs.shape[-2]
    t = (dt * torch.arange(n, dtype=xs.dtype, device=xs.device)).expand(
        xs.shape[:-1])
    seg = hypot(torch.diff(xs[..., 0]), torch.diff(xs[..., 1]))
    s = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, -1)],
                  dim=-1)
    us_full = torch.cat([us, torch.zeros_like(us[..., :1, :])], dim=-2)
    zeros = torch.zeros_like(t)
    return Traj(time=t, s=s, x=xs[..., 0], y=xs[..., 1], theta=xs[..., 2],
                kappa=torch.tan(xs[..., 5]) / wheel_base,
                velocity=xs[..., 3], left_bound=zeros, right_bound=zeros,
                a=xs[..., 4], jerk=us_full[..., 0], delta=xs[..., 5],
                delta_rate=us_full[..., 1])


def make_lane_tuple(left_barrier, right_barrier, cfg: PlannerConfig,
                    dtype=np.float64):
    """Host-side lane constraints of one road (shared by a batch): numpy
    arrays from the per-side barrier polylines [NB2, 2]."""
    return corridor_mod.lane_constraints(np.asarray(left_barrier),
                                         np.asarray(right_barrier),
                                         cfg.corridor, dtype)


def _recheck_solution(scns: Scenario, xs, cfg: PlannerConfig, spec):
    """Per-knot collision mask [B, N] of optimized trajectories xs
    [B, N, 6] (PlanOutput.solve_hits): the two-disc probe at each knot's
    time, the finite road-spec barrier test when the spec is known, every
    barrier point otherwise. (The JAX package's ``t0``, knot 0's absolute
    time in the MPC loop, comes with that loop.)"""
    times = cfg.delta_t * torch.arange(xs.shape[-2], dtype=xs.dtype,
                                       device=xs.device)
    dyn = dyn_polys_at(scns, times)
    return check_optimization_collision(
        scns, xs[..., 0], xs[..., 1], xs[..., 2], cfg.vehicle.radius,
        cfg.vehicle.r2x, cfg.vehicle.f2x, collision_buffer=0.0,
        mode="frenet" if spec is not None else "exact", road_spec=spec,
        dyn_polys=dyn)


def _init_guess_warm_start(cfg: PlannerConfig):
    """IlqrConfig.init_guess: None for "iqr" (the solver runs iqr_init
    itself). The tracker initial guess is not ported."""
    if cfg.ilqr.init_guess == "iqr":
        return None
    if cfg.ilqr.init_guess == "tracker":
        raise NotImplementedError(
            "init_guess='tracker' is not ported yet (ROADMAP.md: queue 1, "
            "item 7, lqr.py and tracker.py)")
    raise ValueError(f"unknown init_guess {cfg.ilqr.init_guess!r}")


def _success(status):
    return ((status == SolverStatus.SUCCESS_GNORM)
            | (status == SolverStatus.SUCCESS_ABS_COST)
            | (status == SolverStatus.SUCCESS_REL_COST))


def brake_goals(goals, gamma):
    """Re-time goal trajectories [..., N, 6] to ``gamma`` of their speed
    along the SAME path (the repair brake round, RepairConfig.brake_factor):
    the new knot k sits at arc length gamma * s_k of the original xy
    polyline (same start point), velocities scaled by gamma and
    accelerations by gamma^2 (kinematic re-timing)."""
    N = goals.shape[-2]
    seg = hypot(torch.diff(goals[..., 0]), torch.diff(goals[..., 1]))
    s = torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, -1)],
                  dim=-1).contiguous()
    s2 = (gamma * s).contiguous()
    idx = torch.clamp(torch.searchsorted(s, s2, right=True) - 1, 0, N - 2)

    def at(col, i):
        return torch.gather(col, -1, i)

    s_i = at(s, idx)
    ds = torch.clamp(at(s, idx + 1) - s_i, min=1e-9)
    t = torch.clamp((s2 - s_i) / ds, 0.0, 1.0)

    def lerp(col):
        return at(col, idx) * (1.0 - t) + at(col, idx + 1) * t

    x = lerp(goals[..., 0])
    y = lerp(goals[..., 1])
    th0 = at(goals[..., 2], idx)
    th = th0 + t * normalize_angle(at(goals[..., 2], idx + 1) - th0)
    v = gamma * lerp(goals[..., 3])
    a = (gamma * gamma) * lerp(goals[..., 4])
    delta = lerp(goals[..., 5])
    return torch.stack([x, y, th, v, a, delta], dim=-1)


def _repair_rounds(rep):
    """(margin, warm, gamma) per repair round: the escalating margin
    rounds, then the brake round when enabled."""
    rounds = [(m, rnd < rep.cold_restart_from, 1.0)
              for rnd, m in enumerate(rep.margins)]
    if rep.brake_factor and rep.brake_factor < 1.0 and rep.margins:
        rounds.append((rep.margins[0], False, float(rep.brake_factor)))
    return rounds


def _repair_ilqr_cfg(cfg: PlannerConfig, warm: bool):
    """Solver config of a repair round: cold rounds tighten the stop
    tolerances to RepairConfig.cold_tol (the tightened problem's cost is
    barrier-dominated, so the production rel-cost stop fires mid-descent)."""
    if warm:
        return cfg.ilqr
    return dataclasses.replace(cfg.ilqr, rel_cost_tol=cfg.repair.cold_tol,
                               abs_cost_tol=cfg.repair.cold_tol,
                               max_iter_num=cfg.repair.cold_max_iter)


def repair_width(B: int, max_fraction: float) -> int:
    """Static width of the repair sub-batch: at least one 128-lane block
    on block-aligned batches."""
    if B <= 16:
        return B
    w = max(8, int(B * max_fraction))
    if B % 128 == 0:
        w = max(128, -(-w // 128) * 128)
    return min(B, w)


def _repair_batch(scns: Scenario, res: SolveResult, hits, goals_b, starts6,
                  cons: ConstraintSet, cfg: PlannerConfig, spec,
                  backend: str = "blast"):
    """Close the safety loop on a batch: gather the near-term-dirty lanes,
    re-solve them (warm-started, then cold) against constraints tightened
    by RepairConfig.margins, re-check, and replace a lane only when its
    re-solve converged and re-checks CLEAN. Returns (final SolveResult,
    final hits, repaired [B], still_dirty [B]).

    A round gathers R = repair_width(B) lanes: the dirty lanes first, in
    index order, the rest of the width CYCLIC COPIES of them (a copy solves
    the same problem, so the round costs the slowest dirty lane). Only the
    first occurrence of each lane, position < number dirty, is written
    back: a scatter of duplicate indices has no defined winner on the card,
    and under backend="mega" copies in other 128-lane exit blocks need not
    end equal (a lane keeps iterating while its block runs). (The JAX
    package's ``t0`` and ``eligible``, for the MPC loop, come with it.)"""
    rep = cfg.repair
    B = goals_b.shape[0]
    near = NEAR_TERM_KNOTS
    R = repair_width(B, rep.max_fraction)
    dev = goals_b.device
    repaired = torch.zeros(B, dtype=torch.bool, device=dev)
    for margin, warm, gamma in _repair_rounds(rep):
        dirty = hits[:, :near].any(-1)
        n_dirty = int(dirty.sum())
        if n_dirty == 0:     # a clean batch pays nothing for the round
            continue
        order = torch.argsort((~dirty).to(torch.uint8), stable=True)
        idx = order[torch.arange(R, device=dev) % n_dirty]
        g_cons = cons.map(lambda a: a[idx])
        ws = (res.xs[idx], res.us[idx]) if warm else None
        g_goals = goals_b[idx]
        if gamma < 1.0:
            g_goals = brake_goals(g_goals, gamma)
        res_r = solve_batch(g_goals, starts6[idx],
                            tighten_constraints(g_cons, margin),
                            _repair_ilqr_cfg(cfg, warm), cfg.vehicle,
                            cfg.delta_t, warm_start=ws, backend=backend)
        hits_r = _recheck_solution(scns.map(lambda a: a[idx]), res_r.xs, cfg,
                                   spec)
        # the repaired trajectory's cost under the PRODUCTION constraints
        # (the re-solve's own is against the tightened problem)
        res_r.cost = total_cost(res_r.xs, res_r.us,
                                transform_goals(goals_b[idx], starts6[idx]),
                                g_cons, cfg.ilqr, cfg.vehicle)
        k = min(n_dirty, R)          # first occurrences: positions < k
        lanes = idx[:k]
        use = (~hits_r[:k, :near].any(-1)) & _success(res_r.status[:k])

        def put(full, part):
            u = use.reshape((k,) + (1,) * (part.dim() - 1))
            return full.index_copy(0, lanes,
                                   torch.where(u, part[:k], full[lanes]))

        res = res.map(put, res_r)
        hits = put(hits, hits_r)
        repaired = repaired.index_copy(0, lanes, repaired[lanes] | use)
    return res, hits, repaired, hits[:, :near].any(-1)


def prep_constraints(cors: CorridorSet, cfg: PlannerConfig) -> ConstraintSet:
    """The solve's constraints from the corridors: shrink and normalize
    (ilqr_optimizer.cc:438-495), then padded slots no lane uses trimmed
    (exact: everything dropped is masked out; one host read of the
    masks)."""
    return trim_constraints(shrink_and_normalize(
        cors.planes, cors.plane_mask, cors.left_planes, cors.left_segs,
        cors.left_mask, cors.right_planes, cors.right_segs, cors.right_mask,
        cfg.ilqr, cfg.vehicle))


def start_states(starts, dtype):
    """(x, y, theta, v) starts [B, 4] -> solver start states [B, 6]."""
    starts = starts.to(dtype)
    return torch.cat([starts, torch.zeros_like(starts[:, :2])], dim=-1)


def plan_batch(scns: Scenario, starts, cfg: PlannerConfig, grid=None,
               lane=None, backend: str = "blast", spec=None) -> PlanOutput:
    """The full replan for a batch: DP -> corridors -> constraint prep ->
    batch.solve_batch (``backend`` "blast": the sweep and cost-stack
    kernels; "mega": the megakernel) -> re-check -> repair ladder.

    scns: Scenario with a leading batch axis [B] (shared road), on the
    device the replan runs on (scenario.make_scenario_batch puts it on
    the card unless told otherwise). starts: [B, 4] (x, y, theta, v).
    grid: must be None (the DP's grid mode is not ported). lane: the road's
    lane constraints (make_lane_tuple; built from the first scenario's
    barriers if None). spec: the road's scenario.RoadSpec, required (the
    DP's closed-form station fields and the finite road-barrier test of
    the DP and the re-check; the DP's path without it is not ported)."""
    if lane is None:
        lane = make_lane_tuple(scns.left_barrier_xy[0].cpu(),
                               scns.right_barrier_xy[0].cpu(), cfg)
    dp_res = dp_mod.plan(scns, starts[:, 0], starts[:, 1], starts[:, 2], cfg,
                         grid, spec=spec)
    cors = corridor_mod.plan_corridors(scns, dp_res.traj, cfg.corridor, lane)
    cons = prep_constraints(cors, cfg)
    goals = coarse_to_states(dp_res.traj)                     # [B, N, 6]
    start6 = start_states(starts, goals.dtype)
    warm = _init_guess_warm_start(cfg)
    res = solve_batch(goals, start6, cons, cfg.ilqr, cfg.vehicle,
                      cfg.delta_t, warm_start=warm, backend=backend)
    ok = dp_res.ok & cors.ok.all(dim=-1)
    hits = _recheck_solution(scns, res.xs, cfg, spec)
    pre_hits = hits
    if cfg.repair.enabled:
        res, hits, repaired, still_dirty = _repair_batch(
            scns, res, hits, goals, start6, cons, cfg, spec, backend=backend)
    else:
        repaired = torch.zeros_like(ok)
        still_dirty = hits[:, :NEAR_TERM_KNOTS].any(-1)
    return PlanOutput(coarse=dp_res.traj, dp_ok=dp_res.ok, corridors=cors,
                      solve=res, ok=ok, solve_hits=hits, pre_hits=pre_hits,
                      repaired=repaired, still_dirty=still_dirty)
