"""The control of the comparison: the reference put in the program's place
and computed one precision below the configuration's float32, in
bfloat16. The comparison has to find it not correct.

The solve runs in bfloat16 arithmetic (the reference's single-problem
solver). The DP and the corridors keep float32 arithmetic, because their
code fixes float32 road tables (the RoadSpec's check of the centerline,
the grid's numpy build), but every input they are given (obstacles,
starts, the plan a cycle is handed) and every output they hand on (the
coarse trajectory, goals, constraints) is held in bfloat16, as a program
that stored its state in bfloat16 would hold it. No repair ladder runs:
the control's plan is its solve."""

from __future__ import annotations

import types

import torch

from portbench import compare
from portbench.kinds import replan as replan_kind
from portbench.ref import scenario as ref_scenario
from portbench.ref import solver as ref_solver
from portbench.ref import stages as ref_stages

BF16 = torch.bfloat16
OBSTACLE_FIELDS = ("static_obs", "dyn_obs")


def _bf(a):
    """A float tensor held in bfloat16 and handed on in its own type."""
    return a.to(BF16).to(a.dtype) if a.is_floating_point() else a


def _rounded_arrays(arrays):
    out = dict(arrays)
    for k in OBSTACLE_FIELDS:
        out[k] = torch.as_tensor(arrays[k]).to(BF16).double().numpy()
    return out


def _solve_bf16(prob, cfg, warm=None):
    dtype = prob.goals.dtype

    def low(a):
        return a.to(BF16) if a.is_floating_point() else a

    res = ref_solver.solve(low(prob.goals), low(prob.starts),
                           prob.cons.map(low), cfg.ilqr, cfg.vehicle,
                           cfg.delta_t,
                           warm_start=None if warm is None
                           else tuple(low(w) for w in warm))
    return types.SimpleNamespace(xs=res.xs.to(dtype), us=res.us.to(dtype),
                                 status=res.status, iters=res.iters)


def _held(prob):
    return prob._replace(goals=_bf(prob.goals), starts=_bf(prob.starts),
                         cons=prob.cons.map(_bf))


def replan_served(cell, arrays, starts, device) -> compare.Served:
    cfg, _, lane, spec = replan_kind.reference_world(cell, arrays, device)
    scns = ref_scenario.scenario_from_arrays(
        _rounded_arrays(arrays), dtype=starts.dtype, device=device)
    prob = _held(ref_stages.replan_problem(scns, _bf(starts), cfg, lane,
                                           spec))
    coarse = prob.coarse.map(_bf)
    res = _solve_bf16(prob, cfg)
    hits = ref_stages.recheck(scns, res.xs, cfg, spec)
    dirty = hits[:, :ref_stages.NEAR_TERM_KNOTS].any(-1)
    call = compare.SolveCall(goals=prob.goals, starts=prob.starts,
                             cons=prob.cons, warm=None, res=res)
    return compare.Served(
        main=call, final=res, ok=prob.dp_ok & prob.corridors.ok.all(-1),
        hits=hits, pre_dirty=dirty, repaired=torch.zeros_like(dirty),
        still_dirty=dirty, coarse=coarse, dp_ok=prob.dp_ok)


def mpc_served(cell, arrays, carry_in, device) -> compare.Served:
    cfg, _, lane, spec = replan_kind.reference_world(cell, arrays, device)
    scns = ref_scenario.scenario_from_arrays(
        _rounded_arrays(arrays), dtype=carry_in.xs.dtype, device=device)
    prob = _held(ref_stages.cycle_problem(scns, _bf(carry_in.xs),
                                          _bf(carry_in.us),
                                          carry_in.cycle_time, cfg, lane))
    res = _solve_bf16(prob, cfg, warm=tuple(_bf(w) for w in prob.warm))
    hits = ref_stages.recheck(scns, res.xs, cfg, spec, t0=prob.t0)
    dirty = hits[:, :ref_stages.NEAR_TERM_KNOTS].any(-1)
    call = compare.SolveCall(goals=prob.goals, starts=prob.starts,
                             cons=prob.cons, warm=prob.warm, res=res)
    carry = types.SimpleNamespace(xs=res.xs, us=res.us, cycle_time=prob.t0,
                                  no_repair=carry_in.no_repair | dirty)
    return compare.Served(
        main=call, final=res, ok=prob.corridors.ok.all(-1), hits=hits,
        pre_dirty=dirty, repaired=torch.zeros_like(dirty), still_dirty=dirty,
        carry_out=(carry, dirty))


def served(kind, cell, arrays, state, device) -> compare.Served:
    """The control's answer for the kept call: ``state`` is the replan's
    starts or the cycle's carry."""
    if kind == "replan":
        return replan_served(cell, arrays, state, device)
    return mpc_served(cell, arrays, state, device)
