"""The reference agrees with the port's plain path at a tiny size on the
CPU: the frozen copy computes what the port computes, bit for bit."""

import numpy as np
import pytest
import torch

from portbench import inputs, registry
from portbench.kinds import replan as replan_kind
from portbench.ref import solver as ref_solver
from portbench.ref import stages as ref_stages


def _cell(name, batch):
    cell = registry.cell(name)
    cell.traffic = {**cell.traffic, "batch": batch, "check_lanes": batch}
    return cell


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        for x, y in zip(a, b):
            _equal(x, y)


@pytest.mark.parametrize("name", ["pedtest_spec.replan",
                                  "pedtest_mapped.replan"])
def test_replan_stages_equal_the_port(name):
    from cilqr_tpu_torch import corridor, dp, pipeline

    cell = _cell(name, 2)
    ctx = replan_kind.program_setup(cell, 2**31 + 77, "cpu", print)
    starts = ctx["starts"][0]
    cfg, scns, lane, spec = replan_kind.reference_world(
        cell, ctx["arrays"], "cpu")
    prob = ref_stages.replan_problem(scns, starts, cfg, lane, spec)
    pcfg = ctx["cfg"]
    d = dp.plan(ctx["scns"], starts[:, 0], starts[:, 1], starts[:, 2], pcfg,
                ctx["grid"], spec=ctx["spec"])
    cors = corridor.plan_corridors(ctx["scns"], d.traj, pcfg.corridor,
                                   ctx["lane"])
    cons = pipeline.prep_constraints(cors, pcfg)
    for f in ("x", "y", "theta", "velocity", "a", "delta"):
        assert torch.equal(getattr(d.traj, f), getattr(prob.coarse, f))
    assert torch.equal(d.ok, prob.dp_ok)
    _equal(tuple(cons), tuple(prob.cons))
    assert torch.equal(cors.ok, prob.corridors.ok)
    goals = pipeline.coarse_to_states(d.traj)
    assert torch.equal(goals, prob.goals)
    xs = goals.clone()
    xs[:, :, 1] += 0.5
    assert torch.equal(
        pipeline._recheck_solution(ctx["scns"], xs, pcfg, ctx["spec"]),
        ref_stages.recheck(scns, xs, cfg, spec))


def test_cycle_problem_and_solver_equal_the_port():
    from cilqr_tpu_torch import batch, mpc

    cell = _cell("pedtest_spec.mpc", 2)
    ctx = replan_kind.program_setup(cell, 5, "cpu", print)
    cfg, scns, lane, spec = replan_kind.reference_world(
        cell, ctx["arrays"], "cpu")
    prob = ref_stages.replan_problem(scns, ctx["starts"][0], cfg, lane, spec)
    f64 = (lambda a: a.double() if a.is_floating_point() else a)
    g, s = prob.goals.double(), prob.starts.double()
    cons = prob.cons.map(f64)
    ours = ref_solver.solve(g, s, cons, cfg.ilqr, cfg.vehicle, cfg.delta_t)
    port = batch.solve_batch(g, s, type(cons)(*cons), ctx["cfg"].ilqr,
                             ctx["cfg"].vehicle, cfg.delta_t, backend="vmap")
    for f in ("xs", "us", "status", "iters"):
        assert torch.equal(getattr(ours, f), getattr(port, f))
    carry = mpc.MpcCarry(xs=ours.xs.float(), us=ours.us.float(),
                         cycle_time=torch.zeros(2))
    goals, warm_us, t_new, cors, pcons = mpc._cycle_problem(
        ctx["scns"], carry, ctx["cfg"], ctx["lane"])
    cp = ref_stages.cycle_problem(scns, carry.xs, carry.us,
                                  carry.cycle_time, cfg, lane)
    assert torch.equal(goals, cp.goals) and torch.equal(warm_us, cp.warm[1])
    assert torch.equal(t_new, cp.t0)
    _equal(tuple(pcons), tuple(cp.cons))
    assert np.isfinite(float(ours.cost.total.sum()))
