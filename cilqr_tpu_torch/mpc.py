"""Receding-horizon MPC loop: warm-started CILQR re-solves along the
trajectory (PyTorch counterpart of cilqr_tpu/mpc.py; BASELINE config 4).

Each cycle shifts the previous plan by one knot (warm start and goals),
rebuilds the safe corridors at the new absolute times (dynamic obstacles
have moved), re-solves, re-checks the executed horizon and runs the
attempt-once repair. ``mpc_step_batch`` / ``mpc_scan_batch`` carry B
vehicles at once through ``batch.solve_batch`` (the kernels on a card);
``mpc_step`` / ``run_mpc`` / ``mpc_scan`` carry one, as a batch of one
through the single-problem solver. The JAX ``lax.scan`` over cycles is a
host loop.
"""

from __future__ import annotations

import dataclasses

import torch

from . import corridor as corridor_mod
from . import pipeline as pipeline_mod
from .batch import solve_batch
from .config import PlannerConfig
from .profiling import spanned
from .types import Scenario, SolveResult, Traj, _Fields


@dataclasses.dataclass
class MpcCarry(_Fields):
    xs: torch.Tensor          # [B, N, 6] current plan ([N, 6] single)
    us: torch.Tensor          # [B, T, 2]
    cycle_time: torch.Tensor  # [B] absolute time of plan knot 0 ([] single)
    # lanes whose repair ladder already FAILED once: the deployment policy
    # is attempt-once-then-flag (a persistently resistant lane stays
    # still_dirty every cycle, visible to the executor, but does not re-run
    # the cold round's whole iteration budget every cycle;
    # pipeline._repair_batch's eligible). None = all lanes eligible
    # (materialized to zeros by the scan entry points).
    no_repair: torch.Tensor | None = None


def _no_repair_of(carry: MpcCarry, shape):
    if carry.no_repair is None:
        return torch.zeros(shape, dtype=torch.bool,
                           device=carry.xs.device)
    return carry.no_repair


@dataclasses.dataclass
class MpcStepOut(_Fields):
    """One cycle's output, per lane.

    corridor_ok: all 81 per-knot corridors were built (a False means the
    solve ran against a degenerate corridor; corridor.cc's failure modes).
    lane_clipped: the solver's windowed lane-segment search clipped at a
    window edge this cycle (SolveResult.lane_clipped): MPC is the drift
    case the guard exists for, since the window is built from the shifted
    GOALS and a warm-started rollout can wander past it. False when the
    solver scanned every segment.
    near_hits: the executed-horizon re-check of this cycle's FINAL plan
    (after the repair): does any of the first NEAR_TERM_KNOTS knots' probes,
    at the cycle's absolute knot times, hit an obstacle or road barrier?
    All False = safe to execute. solve_hits: the per-knot mask behind it.
    pre_near_hits: the same before the repair. repaired / still_dirty: the
    repair's outcome (PlanOutput's); a repaired plan also replaces the
    carry, so the next cycle warm-starts from the safe trajectory."""

    solve: SolveResult
    corridor_ok: torch.Tensor
    lane_clipped: torch.Tensor
    near_hits: torch.Tensor
    solve_hits: torch.Tensor
    pre_near_hits: torch.Tensor
    repaired: torch.Tensor
    still_dirty: torch.Tensor


def _lane_clipped_of(res: SolveResult):
    """SolveResult.lane_clipped, or all False when the backend ran a full
    lane scan (lane_clipped None: nothing to clip)."""
    if res.lane_clipped is None:
        return torch.zeros_like(res.iters, dtype=torch.bool)
    return res.lane_clipped


def _shift_plan(xs, us):
    """Shift one knot forward along the knot axis (-2); hold the tail."""
    return (torch.cat([xs[..., 1:, :], xs[..., -1:, :]], dim=-2),
            torch.cat([us[..., 1:, :], us[..., -1:, :]], dim=-2))


def _cycle_problem(scns: Scenario, carry: MpcCarry, cfg: PlannerConfig,
                   lane):
    """The shifted plan and this cycle's constraints, batched: (goals
    [B, N, 6], warm us, t_new [B], corridors, constraints)."""
    goals, warm_us = _shift_plan(carry.xs, carry.us)
    t_new = carry.cycle_time + cfg.delta_t
    B, n = goals.shape[0], goals.shape[1]
    times = t_new[:, None] + cfg.delta_t * torch.arange(
        n, dtype=goals.dtype, device=goals.device)
    pred = Traj.zeros((B, n), goals.dtype, goals.device).replace(
        x=goals[..., 0], y=goals[..., 1], theta=goals[..., 2], time=times)
    cors = corridor_mod.plan_corridors(scns, pred, cfg.corridor, lane)
    return goals, warm_us, t_new, cors, pipeline_mod.prep_constraints(cors,
                                                                      cfg)


@spanned("mpc_step_batch")
def mpc_step_batch(scns: Scenario, carry: MpcCarry, cfg: PlannerConfig,
                   lane, backend: str = "blast", spec=None
                   ) -> tuple[MpcCarry, MpcStepOut]:
    """Batched replan cycle (BASELINE config 4's throughput path): every
    carry and scenario field has a leading batch axis [B]; the corridors
    are batched and the solve goes through batch.solve_batch (``backend``)
    warm-started per lane from the shifted plan."""
    goals, warm_us, t_new, cors, cons = _cycle_problem(scns, carry, cfg,
                                                       lane)
    res = solve_batch(goals, goals[:, 0], cons, cfg.ilqr, cfg.vehicle,
                      cfg.delta_t, warm_start=(goals, warm_us),
                      backend=backend)
    hits = pipeline_mod._recheck_solution(scns, res.xs, cfg, spec, t0=t_new)
    near = pipeline_mod.NEAR_TERM_KNOTS
    pre_near = hits[:, :near].any(-1)
    no_rep = _no_repair_of(carry, pre_near.shape)
    if cfg.repair.enabled:
        # the repaired plan replaces both the cycle's output AND the carry;
        # lanes that already failed a whole ladder are not re-attempted.
        # no_rep also takes dirty lanes the repair width left untried (the
        # JAX package's rule, kept for parity)
        res, hits, repaired, still_dirty = pipeline_mod._repair_batch(
            scns, res, hits, goals, goals[:, 0], cons, cfg, spec,
            t0=t_new, backend=backend, eligible=~no_rep)
        no_rep = no_rep | still_dirty
    else:
        repaired = torch.zeros_like(pre_near)
        still_dirty = pre_near
    out = MpcStepOut(solve=res, corridor_ok=cors.ok.all(-1),
                     lane_clipped=_lane_clipped_of(res),
                     near_hits=hits[:, :near].any(-1), solve_hits=hits,
                     pre_near_hits=pre_near, repaired=repaired,
                     still_dirty=still_dirty)
    return MpcCarry(xs=res.xs, us=res.us, cycle_time=t_new,
                    no_repair=no_rep), out


def _one(a):
    return a[None]


def _first(a):
    return a[0]


def mpc_step(scn: Scenario, carry: MpcCarry, cfg: PlannerConfig, grid, lane,
             spec=None) -> tuple[MpcCarry, MpcStepOut]:
    """One replan cycle of one vehicle (no batch axis anywhere):
    mpc_step_batch on a batch of one through the single-problem solver
    (backend "vmap"). ``grid`` is unused (the corridors take none), as in
    the JAX function."""
    carry, out = mpc_step_batch(scn.map(_one), carry.map(_one), cfg, lane,
                                backend="vmap", spec=spec)
    return carry.map(_first), out.map(_first)


def run_mpc(scn: Scenario, start, cfg: PlannerConfig, n_cycles: int,
            grid=None, lane=None, spec=None):
    """The initial full plan (pipeline.plan) and n_cycles warm-started
    replans of one vehicle. Returns the list of MpcStepOut; entry 0 wraps
    the initial plan with its own corridor validity."""
    if lane is None:
        lane = pipeline_mod.make_lane_tuple(scn.left_barrier_xy.cpu(),
                                            scn.right_barrier_xy.cpu(), cfg)
    out0 = pipeline_mod.plan(scn, start, cfg, grid, lane, spec=spec)
    carry = MpcCarry(xs=out0.solve.xs, us=out0.solve.us,
                     cycle_time=torch.zeros((), dtype=out0.solve.xs.dtype,
                                            device=out0.solve.xs.device))
    near = pipeline_mod.NEAR_TERM_KNOTS
    results = [MpcStepOut(solve=out0.solve,
                          corridor_ok=out0.corridors.ok.all(),
                          lane_clipped=_lane_clipped_of(out0.solve),
                          near_hits=out0.solve_hits[:near].any(),
                          solve_hits=out0.solve_hits,
                          pre_near_hits=out0.pre_hits[:near].any(),
                          repaired=out0.repaired,
                          still_dirty=out0.still_dirty)]
    for _ in range(n_cycles):
        carry, out = mpc_step(scn, carry, cfg, grid, lane, spec=spec)
        results.append(out)
    return results


@dataclasses.dataclass
class MpcScanStats(_Fields):
    """Per-cycle stats of an MPC rollout, stacked over cycles ([C] or
    [C, B])."""

    status: torch.Tensor
    iters: torch.Tensor
    cost: torch.Tensor
    corridor_ok: torch.Tensor
    lane_clipped: torch.Tensor
    near_hits: torch.Tensor       # after the repair (the executed gate)
    pre_near_hits: torch.Tensor   # before the repair
    repaired: torch.Tensor
    still_dirty: torch.Tensor


def _scan_stats(out: MpcStepOut) -> MpcScanStats:
    return MpcScanStats(status=out.solve.status, iters=out.solve.iters,
                        cost=out.solve.cost.total,
                        corridor_ok=out.corridor_ok,
                        lane_clipped=out.lane_clipped,
                        near_hits=out.near_hits,
                        pre_near_hits=out.pre_near_hits,
                        repaired=out.repaired, still_dirty=out.still_dirty)


def _stack(stats):
    return stats[0].map(lambda *v: torch.stack(v), *stats[1:])


def mpc_scan(scn: Scenario, carry: MpcCarry, cfg: PlannerConfig, grid, lane,
             n_cycles: int, spec=None):
    """n_cycles of mpc_step: mpc_scan_batch on a batch of one (backend
    "vmap"); (final carry, MpcScanStats with [C] fields)."""
    carry, st = mpc_scan_batch(scn.map(_one), carry.map(_one), cfg, lane,
                               n_cycles, backend="vmap", spec=spec)
    return carry.map(_first), st.map(lambda a: a[:, 0])


def mpc_scan_batch(scns: Scenario, carry: MpcCarry, cfg: PlannerConfig,
                   lane, n_cycles: int, backend: str = "blast", spec=None):
    """The batched MPC rollout, n_cycles of mpc_step_batch (the JAX
    package's BENCH_MODE=mpc workload): (final carry, MpcScanStats with
    [C, B] fields). near_hits is each cycle's executed-horizon gate after
    the repair; pre_near_hits, repaired and still_dirty are the repair's
    action, per cycle and lane."""
    carry = carry.replace(
        no_repair=_no_repair_of(carry, carry.cycle_time.shape))
    stats = []
    for _ in range(n_cycles):
        carry, out = mpc_step_batch(scns, carry, cfg, lane, backend=backend,
                                    spec=spec)
        stats.append(_scan_stats(out))
    return carry, _stack(stats)
