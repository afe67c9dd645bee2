"""The full replan (PyTorch counterpart of cilqr_tpu/pipeline.py): DP
coarse search -> safe corridors -> constraint prep -> CILQR solve ->
per-knot collision re-check -> repair ladder.

A batch is on one road (its grid, lane constraints and RoadSpec given or
built from its first scenario), or each lane on a road of its own: a
RoadLibrary (``road_library``) and a road index per lane, whose operands
``lane_roads`` gathers each call.

``plan_batch`` is the replan step the JAX package's pipeline benchmark
times (the reference's per-cycle DP -> corridor -> iLQR sequence,
trajectory_planner.cpp:28-94, for a batch of scenarios); ``plan`` is one
scenario through the single-problem solver (TrajectoryPlanner::Plan).
Tensors stay on the device of the scenarios given; the repair ladder's
rounds are host branches on whether any eligible lane is dirty (the JAX
package's ``lax.cond``), one device sync a round.
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
from .profiling import active, count, host, span, spanned
from .reference_line import arc_lengths, centerline_rows
from .solver import transform_goals
from .types import (CorridorSet, Scenario, SolveResult, SolverStatus, Traj,
                    _Fields)
from .world import (RoadLibrary, build_barrier_grid, build_road_library,
                    check_optimization_collision, dyn_polys_at, lane_grid)

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
    s = arc_lengths(hypot(torch.diff(xs[..., 0]), torch.diff(xs[..., 1])))
    us_full = torch.cat([us, torch.zeros_like(us[..., :1, :])], dim=-2)
    zeros = torch.zeros_like(t)
    return Traj(time=t, s=s, x=xs[..., 0], y=xs[..., 1], theta=xs[..., 2],
                kappa=torch.tan(xs[..., 5]) / wheel_base,
                velocity=xs[..., 3], left_bound=zeros, right_bound=zeros,
                a=xs[..., 4], jerk=us_full[..., 0], delta=xs[..., 5],
                delta_rate=us_full[..., 1])


def make_lane_tuple(left_barrier, right_barrier, cfg: PlannerConfig,
                    dtype=np.float64):
    """Host-side lane constraints of one road: numpy arrays from the
    per-side barrier polylines [NB2, 2]; shared by a batch on that road,
    or one road's entry of a RoadLibrary (road_library)."""
    return corridor_mod.lane_constraints(np.asarray(left_barrier),
                                         np.asarray(right_barrier),
                                         cfg.corridor, dtype)


@spanned("recheck")
def _recheck_solution(scns: Scenario, xs, cfg: PlannerConfig, spec,
                      t0=None):
    """Per-knot collision mask [B, N] of optimized trajectories xs
    [B, N, 6] (PlanOutput.solve_hits): the two-disc probe at each knot's
    absolute time, the finite road-spec barrier test when the spec is
    known, every barrier point otherwise. t0 [B]: the absolute time of
    each lane's knot 0 (the MPC loop's cycle time, where the dynamic
    obstacles have advanced); None = 0 (the one-shot replan)."""
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


def _init_guess_warm_start(cfg: PlannerConfig, start_state, coarse: Traj):
    """IlqrConfig.init_guess, the reference's source-edit switch between
    the backward-LQR iqr() guess and the Tracker simulation
    (ilqr_optimizer.cc:107-139,168-169): a solver warm_start (xs, us) from
    tracker.plan for "tracker", None for "iqr" (the solver runs iqr_init
    itself). start_state [B, 6] with coarse fields [B, N], or [6] with
    [N]."""
    if cfg.ilqr.init_guess == "iqr":
        return None
    if cfg.ilqr.init_guess != "tracker":
        raise ValueError(f"unknown init_guess {cfg.ilqr.init_guess!r}")
    from . import tracker as tracker_mod

    if start_state.dim() == 1:
        xs, us = tracker_mod.plan(start_state[None],
                                  coarse.map(lambda a: a[None]), cfg.tracker,
                                  cfg.vehicle)
        return xs[0], us[0]
    return tracker_mod.plan(start_state, coarse, cfg.tracker, cfg.vehicle)


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
    s = arc_lengths(hypot(torch.diff(goals[..., 0]),
                          torch.diff(goals[..., 1]))).contiguous()
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


@spanned("repair")
def _repair_batch(scns: Scenario, res: SolveResult, hits, goals_b, starts6,
                  cons: ConstraintSet, cfg: PlannerConfig, spec, t0=None,
                  backend: str = "blast", eligible=None):
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
    end equal (a lane keeps iterating while its block runs).

    t0 [B]: the absolute time of each lane's knot 0 for the re-check (the
    MPC cycles); None = 0. eligible [B] bool: the lanes the ladder may
    attempt (the MPC loop passes ~MpcCarry.no_repair, so that a lane that
    already failed a whole ladder stays flagged still_dirty without
    re-running it every cycle); None = all. still_dirty is every lane's
    final near-term re-check, eligible or not."""
    rep = cfg.repair
    B = goals_b.shape[0]
    near = NEAR_TERM_KNOTS
    R = repair_width(B, rep.max_fraction)
    dev = goals_b.device
    repaired = torch.zeros(B, dtype=torch.bool, device=dev)
    for rnd, (margin, warm, gamma) in enumerate(_repair_rounds(rep)):
        dirty = hits[:, :near].any(-1)
        if eligible is not None:
            dirty = dirty & eligible
        n_dirty = int(host(dirty.sum()))
        if n_dirty == 0:     # a clean batch pays nothing for the round
            continue
        kind = "warm" if warm else "cold" if gamma == 1.0 else "brake"
        with span("repair.round", round=rnd, n_dirty=n_dirty, R=R,
                  kind=kind):
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
            hits_r = _recheck_solution(
                scns.map(lambda a: a[idx]), res_r.xs, cfg, spec,
                t0=None if t0 is None else t0[idx])
            # the repaired trajectory's cost under the PRODUCTION constraints
            # (the re-solve's own is against the tightened problem)
            res_r.cost = total_cost(
                res_r.xs, res_r.us,
                transform_goals(goals_b[idx], starts6[idx]), g_cons,
                cfg.ilqr, cfg.vehicle)
            k = min(n_dirty, R)          # first occurrences: positions < k
            lanes = idx[:k]
            use = ((~hits_r[:k, :near].any(-1))
                   & _success(res_r.status[:k]))

            def put(full, part):
                u = use.reshape((k,) + (1,) * (part.dim() - 1))
                return full.index_copy(0, lanes,
                                       torch.where(u, part[:k], full[lanes]))

            res = res.map(put, res_r)
            hits = put(hits, hits_r)
            repaired = repaired.index_copy(0, lanes, repaired[lanes] | use)
        count("repair.rounds", 1)
        count("repair.lanes_dirty", min(n_dirty, R))
        count("repair.lanes_launched", R)
        count("repair.lanes_replaced", use)
    return res, hits, repaired, hits[:, :near].any(-1)


@spanned("corridors.prep")
def prep_constraints(cors: CorridorSet, cfg: PlannerConfig) -> ConstraintSet:
    """The solve's constraints from the corridors: shrink and normalize
    (ilqr_optimizer.cc:438-495), then padded slots no lane uses trimmed
    (exact: everything dropped is masked out; one host read of the
    masks)."""
    return trim_constraints(shrink_and_normalize(
        cors.planes, cors.plane_mask, cors.left_planes, cors.left_segs,
        cors.left_mask, cors.right_planes, cors.right_segs, cors.right_mask,
        cfg.ilqr, cfg.vehicle))


def road_grid(barrier_xy, cfg: PlannerConfig):
    """The road's BarrierGrid for the DP's grid mode, as the JAX package's
    ``plan`` builds it: cell ``DpConfig.grid_cell``, the dilated table for
    the vehicle radius, the origin in the barrier points' type, on their
    device."""
    return build_barrier_grid(barrier_xy, cfg.dp.grid_cell,
                              half=cfg.vehicle.radius,
                              dtype=barrier_xy.dtype,
                              device=barrier_xy.device)


@spanned("roads.build")
def road_library(road_scns: Scenario, cfg: PlannerConfig, lanes=None,
                 dtype=np.float64) -> RoadLibrary:
    """The RoadLibrary of R roads, each given by a scenario on it
    (``road_scns``, a Scenario batch [R], padded as
    scenario.stack_scenario_arrays pads roads of unequal length): every
    road's dilated grid table as road_grid builds it, in one batched pass
    on the scenarios' device; its centerline row count; and its lane
    constraints, stacked [R, S, ...] on the device, each road's
    make_lane_tuple in ``dtype`` (numpy; float64 as make_lane_tuple's),
    built in one pass (corridor.lane_constraints_batch) from ``lanes``,
    the padded per-side polylines and their masks (left_xy, left_mask,
    right_xy, right_mask) [R, NB2, ...], or if None the scenarios' own."""
    xy = road_scns.barrier_xy
    lib = build_road_library(xy, road_scns.barrier_mask, cfg.dp.grid_cell,
                             half=cfg.vehicle.radius, dtype=xy.dtype)
    if lanes is None:
        lanes = tuple(a.cpu().numpy() for a in (
            road_scns.left_barrier_xy, road_scns.left_barrier_mask,
            road_scns.right_barrier_xy, road_scns.right_barrier_mask))
    built = corridor_mod.lane_constraints_batch(*lanes, cfg.corridor, dtype)
    stacked = tuple(torch.as_tensor(a, device=xy.device) for a in built)
    rows = centerline_rows(road_scns.centerline.s)
    if int(rows.min()) < 2:
        raise ValueError("road_library: a road's centerline has fewer than "
                         "2 rows")
    count("roads.table_bytes", lib.dilated.numel())
    return lib._replace(rows=rows, lanes=stacked)


@spanned("roads")
def lane_roads(library: RoadLibrary, roads):
    """Each lane's road operands for a call, gathered from the library on
    its device: (world.LaneGrid, the lane constraints [B, S, ...] as
    corridor.plan_corridors takes them, the centerline row counts [B]).
    roads [B] int64: lane i is on road roads[i]."""
    if active():
        seen = torch.zeros(library.n_roads, dtype=torch.bool,
                           device=roads.device)
        count("roads.count", seen.index_fill_(0, roads, True))
    return (lane_grid(library, roads), tuple(a[roads] for a in library.lanes),
            library.rows[roads])


def start_states(starts, dtype):
    """(x, y, theta, v) starts [B, 4] -> solver start states [B, 6]."""
    starts = starts.to(dtype)
    return torch.cat([starts, torch.zeros_like(starts[:, :2])], dim=-1)


@spanned("plan_batch")
def plan_batch(scns: Scenario, starts, cfg: PlannerConfig, grid=None,
               lane=None, backend: str = "blast", spec=None,
               library: RoadLibrary | None = None, roads=None
               ) -> PlanOutput:
    """The full replan for a batch: DP -> corridors -> constraint prep ->
    batch.solve_batch (``backend`` "blast": the sweep and cost-stack
    kernels; "mega": the megakernel; "vmap": the single-problem solver)
    -> re-check -> repair ladder.

    scns: Scenario with a leading batch axis [B], on the device the replan
    runs on (scenario.make_scenario_batch puts it on the card unless told
    otherwise): one road shared by the batch, or with ``library`` each
    lane on a road of its own. starts: [B, 4] (x, y, theta, v).
    grid: the road's world.BarrierGrid for the DP's ``collision_mode``
    "grid" (built from the first scenario's barriers, with the vehicle
    radius as its half-size, if None then), ignored in the other modes.
    lane: the road's lane constraints (make_lane_tuple; built from the
    first scenario's barriers if None). spec: the road's
    scenario.RoadSpec, or None: with it the DP's station fields are
    closed-form and the DP and the re-check take its finite road-barrier
    test; without it the DP reads the centerline table (and in frenet mode
    takes the station-field stand-in), and the re-check tests every
    barrier point.

    library: a RoadLibrary (road_library) for a batch whose lanes are on
    roads of their own, lane i on road ``roads[i]`` (int64 [B]; None: lane
    i on road i of a library of B roads). The DP then reads each lane's
    own grid table and centerline rows, the corridors each lane's own lane
    constraints (``lane_roads``), and the re-check and the repair ladder
    each lane's own barrier points; ``grid``, ``lane`` and ``spec`` are
    not taken."""
    rows = None
    if library is not None:
        if grid is not None or lane is not None or spec is not None:
            raise ValueError("plan_batch: a RoadLibrary gives each lane its "
                             "grid and lane constraints, and takes no "
                             "RoadSpec")
        if roads is None:
            B = starts.shape[0]
            if library.n_roads != B:
                raise ValueError(f"plan_batch: {library.n_roads} roads for "
                                 f"{B} lanes and no road index")
            roads = torch.arange(B, device=starts.device)
        grid, lane, rows = lane_roads(library, roads)
    if lane is None:
        lane = make_lane_tuple(scns.left_barrier_xy[0].cpu(),
                               scns.right_barrier_xy[0].cpu(), cfg)
    if grid is None and cfg.dp.collision_mode == "grid":
        grid = road_grid(scns.barrier_xy[0], cfg)
    dp_res = dp_mod.plan(scns, starts[:, 0], starts[:, 1], starts[:, 2], cfg,
                         grid, spec=spec, rows=rows)
    cors = corridor_mod.plan_corridors(scns, dp_res.traj, cfg.corridor, lane)
    cons = prep_constraints(cors, cfg)
    goals = coarse_to_states(dp_res.traj)                     # [B, N, 6]
    start6 = start_states(starts, goals.dtype)
    warm = _init_guess_warm_start(cfg, start6, dp_res.traj)
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


def _repair_single(scn: Scenario, res: SolveResult, hits, goals, start_state,
                   cons: ConstraintSet, cfg: PlannerConfig, spec, t0=None,
                   eligible=None):
    """Single-lane repair: _repair_batch on a batch of one through the
    single-problem solver (backend "vmap"). No batch axis: hits [N], goals
    [N, 6], start_state [6]; t0: knot 0's absolute time (0-dim), None = 0;
    eligible: 0-dim bool, None = eligible. Returns (res, hits,
    repaired)."""
    def one(a, dtype=None):
        return None if a is None else torch.as_tensor(
            a, dtype=dtype, device=goals.device).reshape(1)

    res, hits, repaired, _ = _repair_batch(
        scn.map(lambda a: a[None]), res.map(lambda a: a[None]), hits[None],
        goals[None], start_state[None], cons.map(lambda a: a[None]), cfg,
        spec, t0=one(t0, goals.dtype), backend="vmap",
        eligible=one(eligible, torch.bool))
    return res.map(lambda a: a[0]), hits[0], repaired[0]


def plan(scn: Scenario, start, cfg: PlannerConfig, grid=None, lane=None,
         spec=None) -> PlanOutput:
    """TrajectoryPlanner::Plan (trajectory_planner.cpp:28-162) for one
    scenario (no batch axis): plan_batch on a batch of one through the
    single-problem solver (backend "vmap"); every PlanOutput field is
    unbatched.

    start: (x, y, theta, v); the reference's fixed StartState is (0, 0, 0,
    10) (planning_node.cc:24-27). grid, lane: the road's BarrierGrid (in
    grid mode) and lane constraints, built from the scenario's barriers if
    None. spec: the road's scenario.RoadSpec or None, as in plan_batch
    (the JAX package's default call passes none)."""
    x = scn.centerline.x
    starts = torch.as_tensor(start, dtype=x.dtype, device=x.device)
    out = plan_batch(scn.map(lambda a: a[None]), starts.reshape(1, 4), cfg,
                     grid, lane, backend="vmap", spec=spec)
    return out.map(lambda a: a[0])


def plan_jit(cfg: PlannerConfig, spec=None):
    """The planner as a closure over a static config (the JAX package's
    jitted closure; nothing is traced here): f(scn, start, grid, lane)."""
    def _plan(scn, start, grid, lane):
        return plan(scn, start, cfg, grid, lane, spec=spec)

    return _plan
