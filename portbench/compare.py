"""The comparison that decides ``correct``: what the timed path produced in
one call of the window, against the plain reference (``ref``), which works
out again from the benchmark's own inputs what the program derived.

Four numbers, each with a limit of the cell's own (``limits/<cell>.json``):

- ``lanes_off``: the share of the call's lanes on which a layer departs
  from the reference: the DP's coarse trajectory or its ok flag (replans),
  the solve's goals, starts and constraints, the corridors' ok flags, the
  re-check of the solve's plan and of the final plan, the repair ladder's
  bookkeeping (a lane is replaced only when it was near-term dirty and its
  re-solve concluded clean; every other lane keeps the solve's plan;
  still_dirty is the final re-check), and in the MPC loop the carry that the
  cycle hands on.
- ``step_residual``: the widest departure, over every lane of the solve's
  plan and of the final plan, of a knot from the dynamics' step from the
  knot before under the planned control (and of knot 0 from the start),
  in units of the rounding of that step in the plan's type: the plan has
  to follow from its start under its own controls.
- ``cost_excess``: the median, over lanes drawn from the seed (in an MPC
  cycle those that the reference's solve moves off the warm start), of the
  solve's cost above the reference's float64 solve of the same problem,
  both costed by the reference in float64, as a share of the reference's
  cost (at least 1). The solve's decisions are chaotic in float32 (a lane's
  line search can take another branch on a rounding), so single lanes land
  in other local optima on either side; the median is steady.
- ``lanes_stalled``: the share of the sampled lanes that the reference's
  solve moves off the initial guess (the LQR guess, or the shifted plan of
  an MPC cycle) while the program's plan stays at the guess, where the
  guess costs over 1% more: a solve that hands back its guess, on all of
  its lanes or on one block of them, which the median above and a plan's
  own dynamics cannot see.

The program's objects are read by their fields only; nothing here imports
the program.
"""

from __future__ import annotations

import dataclasses
import math
import types

import torch

from .ref import costs as ref_costs
from .ref import model as ref_model
from .ref import solver as ref_solver
from .ref.stages import NEAR_TERM_KNOTS, Problem

PATH_TOL = 1e-2   # m, m/s: a coarse knot or goal that moved by more is off
CONS_TOL = 1e-4   # a normalised half-plane coefficient that moved by more
CONVERGED = (1, 2, 3)


@dataclasses.dataclass
class SolveCall:
    """A solve as the program was asked for it and what it returned."""

    goals: torch.Tensor
    starts: torch.Tensor
    cons: tuple
    warm: tuple | None
    res: object


@dataclasses.dataclass
class Served:
    """What the timed path produced in the sampled call, every field with
    the batch leading. ``final`` is the plan the call emitted (xs, us,
    status); ``main`` the batch's solve before the repair ladder.
    ``pre_dirty`` is the near-term re-check before the repair; ``hits`` the
    final per-knot re-check; replans also carry the DP's coarse trajectory
    and ok flags, MPC cycles the carry handed on."""

    main: SolveCall
    final: object
    ok: torch.Tensor
    hits: torch.Tensor
    pre_dirty: torch.Tensor
    repaired: torch.Tensor
    still_dirty: torch.Tensor
    coarse: object = None
    dp_ok: torch.Tensor | None = None
    carry_out: object = None


def _rows_off(a, b, tol):
    """[B] bool: rows of a and b (batch leading) differ by more than tol, or
    in shape."""
    if a.shape != b.shape:
        return torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    d = (a.double() - b.double()).abs().reshape(a.shape[0], -1)
    return ~(d <= tol).all(-1)


def _mask_off(a, b):
    if a.shape != b.shape:
        return torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    return (a != b).reshape(a.shape[0], -1).any(-1)


def path_off(prog, ref):
    """Lanes whose coarse trajectory departs: x, y or speed of a knot."""
    off = torch.zeros(prog.x.shape[0], dtype=torch.bool, device=prog.x.device)
    for f in ("x", "y", "velocity"):
        off |= _rows_off(getattr(prog, f), getattr(ref, f), PATH_TOL)
    return off


def _masked_planes(planes, mask):
    return torch.where(mask[..., None], planes, torch.zeros_like(planes))


def constraints_off(call: SolveCall, prob: Problem):
    """Lanes whose solve was given other goals, starts or constraints than
    the reference works out."""
    off = _rows_off(call.goals, prob.goals, PATH_TOL)
    off |= _rows_off(call.starts[:, :4], prob.starts[:, :4], PATH_TOL)
    pc, rc = call.cons, prob.cons
    off |= _mask_off(pc.corridor_mask, rc.corridor_mask)
    if pc.corridor_mask.shape == rc.corridor_mask.shape:
        off |= _rows_off(_masked_planes(pc.corridor_planes, pc.corridor_mask),
                         _masked_planes(rc.corridor_planes, rc.corridor_mask),
                         CONS_TOL)
    for side in ("left", "right"):
        pm, rm = getattr(pc, side + "_mask"), getattr(rc, side + "_mask")
        off |= _mask_off(pm, rm)
        if pm.shape == rm.shape:
            for f, tol in (("_planes", CONS_TOL), ("_segs", PATH_TOL)):
                p, r = getattr(pc, side + f), getattr(rc, side + f)
                mk = pm.reshape(pm.shape + (1,) * (p.dim() - pm.dim()))
                off |= _rows_off(torch.where(mk, p, torch.zeros_like(p)),
                                 torch.where(mk, r, torch.zeros_like(r)), tol)
    return off


def _same_plan(a, b):
    return ((a.xs == b.xs).flatten(1).all(-1)
            & (a.us == b.us).flatten(1).all(-1))


def _converged(status):
    return torch.isin(status.long(), torch.tensor(CONVERGED,
                                                  device=status.device))


def repair_off(s: Served, hits_main, hits_final, eligible=None):
    """Lanes whose re-checks or repair bookkeeping depart: the program's
    flags against the reference's re-check of the same plans."""
    near = NEAR_TERM_KNOTS
    ref_pre = hits_main[:, :near].any(-1)
    ref_dirty = hits_final[:, :near].any(-1)
    off = s.pre_dirty != ref_pre
    off |= (s.hits != hits_final).any(-1)
    off |= s.still_dirty != ref_dirty
    may = ref_pre if eligible is None else ref_pre & eligible
    off |= s.repaired & ~may
    off |= ~s.repaired & ~_same_plan(s.final, s.main.res)
    off |= s.repaired & ~(_converged(s.final.status) & ~ref_dirty)
    return off


ANGLES = (2, 5)   # theta and delta: compared modulo 2 pi
ULPS = 8          # a step's rounding floor, in units of its type's epsilon
STALL = 0.1       # a plan within this share of the reference's move from
                  # the guess has stayed at the guess
STALL_COST = 0.01  # ... where the guess costs this share more than the
                   # reference's solve


def _wrapped(d):
    a = torch.tensor(ANGLES, device=d.device)
    d = d.clone()
    d[..., a] = torch.remainder(d[..., a] + math.pi, 2 * math.pi) - math.pi
    return d


def step_residual(xs, us, starts, dt, wheel_base, warm=None):
    """[B] how far a plan departs from its own dynamics, in units of the
    rounding that one step of them carries in the plan's type.

    Each knot's state (x, y, theta, v, a, delta; angles modulo 2 pi) is
    held against the float64 step of the dynamics from the knot before
    under the planned control. The step's rounding is the gap between the
    same step taken in the plan's type and in float64 (where a plan steers
    near +-pi/2 one step amplifies rounding without bound, and so does the
    gap), floored at ULPS epsilons of the state. Knot 0's (x, y, theta, v)
    is held against the lane's start in the same units. A sound plan reads
    about 1 or less; controls altered after the plan was rolled out, or a
    plan kept in a lower precision, read thousands.

    ``warm``: the warm start the reference worked out (an MPC cycle's
    shifted plan, whose held last knot does not follow from the one before).
    A plan equal to it bit for bit is the solve's answer that it found no
    step to take; its steps are the reference's own, and only its start is
    held."""
    X, U = xs.double(), us.double()
    exact = ref_model.dynamics_rk2(X[:, :-1], U, dt, wheel_base)
    own = ref_model.dynamics_rk2(xs[:, :-1], us, dt, wheel_base).double()
    eps = ULPS * torch.finfo(xs.dtype).eps
    scale = _wrapped(own - exact).abs() + eps * (X[:, 1:].abs() + 1.0)
    r = (_wrapped(X[:, 1:] - exact).abs() / scale).amax((-2, -1))
    if warm is not None:
        r = torch.where(_same_plan(types.SimpleNamespace(xs=xs, us=us),
                                   types.SimpleNamespace(xs=warm[0],
                                                         us=warm[1])),
                        torch.zeros_like(r), r)
    s0 = starts[:, :4].double()
    d0 = _wrapped(torch.cat([X[:, 0, :4] - s0,
                             torch.zeros_like(s0[:, :2])], -1))[:, :4]
    r = torch.maximum(r, (d0.abs() / (eps * (s0.abs() + 1.0))).amax(-1))
    return torch.nan_to_num(r, nan=float("inf"))


def _f64(a):
    return a.double() if a.is_floating_point() else a


@dataclasses.dataclass
class LaneCheck:
    """The program's main solve against the reference's float64 solve of
    the same problem, on the sampled lanes (each field [len(lanes)]).

    ``excess``: the cost of the program's plan above the reference's, as a
    share of the latter (at least 1), both costed in float64 by the
    reference. ``moved``: the reference's solve left its initial guess (the
    LQR guess of a replan, the shifted plan of an MPC cycle). ``stay``: how
    far the program's plan lies from that guess, as a share of how far the
    reference's lies from it (x and y, the widest knot): 0 where the
    program handed back its guess."""

    excess: torch.Tensor
    moved: torch.Tensor
    stay: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    ref_status: torch.Tensor
    ref_iters: torch.Tensor


def _xy_gap(a, b):
    return (a[..., :2] - b[..., :2]).abs().flatten(1).amax(-1)


def solve_check(prob: Problem, res, lanes, cfg) -> LaneCheck:
    """The reference's float64 solve of the sampled lanes, and the program's
    plan held against it."""
    sel = torch.as_tensor(lanes, device=prob.goals.device)
    g, s = _f64(prob.goals[sel]), _f64(prob.starts[sel])
    cons = prob.cons.map(lambda a: _f64(a[sel]))
    warm = None if prob.warm is None else tuple(_f64(w[sel])
                                                for w in prob.warm)
    ref = ref_solver.solve(g, s, cons, cfg.ilqr, cfg.vehicle, cfg.delta_t,
                           warm_start=warm)
    goals = ref_solver.transform_goals(g, s)
    xs, us = _f64(res.xs[sel]), _f64(res.us[sel])
    jp = ref_costs.total_cost(xs, us, goals, cons, cfg.ilqr,
                              cfg.vehicle).total
    jr = ref.cost.total
    e = (jp - jr) / torch.clamp(jr.abs(), min=1.0)
    d_ref = _xy_gap(ref.xs, ref.init_xs)
    d_prog = _xy_gap(xs, ref.init_xs)
    stay = torch.where(d_ref > 0, d_prog / torch.where(d_ref > 0, d_ref, 1.0),
                       torch.full_like(d_ref, math.inf))
    return LaneCheck(excess=torch.nan_to_num(e, nan=math.inf),
                     moved=(ref.xs != ref.init_xs).flatten(1).any(-1),
                     stay=torch.nan_to_num(stay, nan=math.inf),
                     status=res.status[sel], iters=res.iters[sel],
                     ref_status=ref.status, ref_iters=ref.iters)


def numbers(off, gaps, lc: LaneCheck, warm: bool):
    """The compared numbers, and details for the log.

    ``cost_excess`` is the median excess over the sampled lanes (in an MPC
    cycle, ``warm``, over those the reference moves: a warm re-solve at its
    optimum keeps the shifted plan, and every such lane reads 0).
    ``lanes_stalled`` is the share of the sampled lanes that the reference
    moves off the initial guess while the program's plan stays within
    ``STALL`` of the guess (as a share of the reference's move) and costs
    over ``STALL_COST`` more than the reference's: a solve that hands back
    its guess on any of its lanes. (A sound float32 warm re-solve at its
    optimum can stop where the float64 one takes a last small step.) Its
    denominator is every sampled lane, not the moved ones, whose count an
    MPC cycle makes as small as 19."""
    e = lc.excess.double()
    stalled = lc.moved & (lc.stay <= STALL) & (e > STALL_COST)
    if warm:
        e = e[lc.moved] if bool(lc.moved.any()) else torch.zeros_like(e[:1])
    return ({"lanes_off": float(off.double().mean()),
             "step_residual": float(torch.stack([g.max() for g in gaps]
                                                 ).max()),
             "cost_excess": float(e.median()),
             "lanes_stalled": float(stalled.double().mean())},
            {"lanes_off_count": int(off.sum()), "lanes": int(off.numel()),
             "cost_excess_max": float(e.max()),
             "cost_excess_min": float(e.min()),
             "cost_lanes": int(e.numel()),
             "stalled_count": int(stalled.sum()),
             "moved_count": int(lc.moved.sum()),
             "sampled": int(lc.moved.numel())})


def verdict(values: dict, limits: dict):
    """(correct, {name: {value, limit}}): every number at or under its
    limit (a NaN is over)."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in values}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
