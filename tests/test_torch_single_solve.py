"""The port's single-problem solver (solver.solve, solve_with_history, both
line-search modes), batch.solve_batch(backend="vmap"),
costs.cost_derivatives and the autodiff Jacobians against the JAX package,
float64 on the CPU.

The problems are the port's own replan's: plan_batch on seeds 0, 1, 2 and
156 (tests/test_torch_replan.py's configuration), its goals, starts and
trimmed constraints converted to numpy for the JAX side. Tolerances:
- cost_derivatives and dynamics_jacobian(mode="autodiff") at the replan's
  final iterate: within 1e-12, scaled by 1 + |value|;
- solve against jax.vmap(solver.solve) (one jit per line-search mode):
  status and iterations identical on at least 3 of the 4 lanes, controls
  within 1e-6 on those (the accept tests are chaotic at their thresholds);
- solve_with_history replays solve: its final result equals solve's bit
  for bit, and its history ends at the final cost;
- backend="vmap" against backend="blast": decisions identical on at least
  3 of 4 lanes, controls within 1e-5 on those (reassociation noise through
  a dozen iterations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import costs as JCo
from cilqr_tpu import model as JM
from cilqr_tpu import solver as JS
from cilqr_tpu.config import PlannerConfig as JPlannerConfig
from cilqr_tpu_torch import batch as TB
from cilqr_tpu_torch import costs as TCo
from cilqr_tpu_torch import model as TM
from cilqr_tpu_torch import pipeline as TP
from cilqr_tpu_torch import solver as TSo

import torch_shared

SEEDS = torch_shared.SEEDS
CFG = torch_shared.replan_config()
JCFG = JPlannerConfig()
F64 = torch.float64


def _mode(cfg, mode):
    return dataclasses.replace(cfg, line_search=dataclasses.replace(
        cfg.line_search, mode=mode))


def _scaled(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float((np.abs(got - want) / (1.0 + np.abs(want))).max())


@pytest.fixture(scope="module")
def problem(request, tmp_path_factory):
    """The port's replan on SEEDS (computed once a test run:
    torch_shared): (goals, starts, constraints, its output)."""
    out = torch_shared.replan(request, tmp_path_factory)
    starts = torch.tensor(torch_shared.START, dtype=F64).repeat(
        len(SEEDS), 1)
    return (TP.coarse_to_states(out.coarse), TP.start_states(starts, F64),
            TP.prep_constraints(out.corridors, CFG), out)


def _jax_cons(cons):
    return JCo.ConstraintSet(*(jnp.asarray(v.numpy()) for v in cons))


def test_cost_derivatives_and_autodiff_match_jax(problem):
    goals, starts, cons, out = problem
    g = TSo.transform_goals(goals, starts)
    xs, us = out.solve.xs, out.solve.us
    got = TCo.cost_derivatives(xs, us, g, cons, CFG.ilqr, CFG.vehicle)
    want = jax.vmap(lambda x, u, gg, c: JCo.cost_derivatives(
        x, u, gg, c, JCFG.ilqr, JCFG.vehicle))(
            jnp.asarray(xs.numpy()), jnp.asarray(us.numpy()),
            jnp.asarray(g.numpy()), _jax_cons(cons))
    for name, a, b in zip(("Jx", "Ju", "Hx", "Hu"), got, want):
        assert a.shape == b.shape, name
        assert _scaled(a.numpy(), b) <= 1e-12, name
    # the barrier terms are live on this iterate
    assert float(got[0][..., 2].abs().max()) > 1e-3

    dt, L = CFG.delta_t, CFG.vehicle.wheel_base
    A, B = TM.dynamics_jacobian(xs[:, :-1], us, dt, L, mode="autodiff")
    Aj, Bj = JM.dynamics_jacobian(jnp.asarray(xs[:, :-1].numpy()),
                                  jnp.asarray(us.numpy()), dt, L,
                                  mode="autodiff")
    assert A.shape == (4, 80, 6, 6) and B.shape == (4, 80, 6, 2)
    assert _scaled(A.numpy(), Aj) <= 1e-12
    assert _scaled(B.numpy(), Bj) <= 1e-12
    # the exact Jacobian differs from the reference's analytic one (its
    # v-for-v_mid quirk), which is why it is a mode of its own
    Aa, _ = TM.dynamics_jacobian(xs[:, :-1], us, dt, L)
    assert float((Aa - A).abs().max()) > 1e-6


@pytest.mark.parametrize("mode", ["serial", "parallel"])
def test_solve_matches_jax(problem, mode):
    goals, starts, cons, _ = problem
    ilqr, jilqr = _mode(CFG.ilqr, mode), _mode(JCFG.ilqr, mode)
    veh, dt = CFG.vehicle, CFG.delta_t
    res = TSo.solve(goals, starts, cons, ilqr, veh, dt)
    jres = jax.jit(jax.vmap(lambda g, s, c: JS.solve(
        g, s, c, jilqr, JCFG.vehicle, JCFG.delta_t)))(
            jnp.asarray(goals.numpy()), jnp.asarray(starts.numpy()),
            _jax_cons(cons))
    st, it = res.status.numpy(), res.iters.numpy()
    assert np.isin(st, (1, 2, 3)).all(), st
    same = (st == np.asarray(jres.status)) & (it == np.asarray(jres.iters))
    assert same.sum() >= 3, (st, it, np.asarray(jres.iters))
    du = np.abs(res.us.numpy() - np.asarray(jres.us)).max(axis=(1, 2))
    assert du[same].max() <= 1e-6, du
    assert not res.lane_clipped.any()

    # solve_with_history replays the same solve
    rh, hist, xs_hist = TSo.solve_with_history(
        goals, starts, cons, ilqr, veh, dt, record_trajs=True)
    for f in ("xs", "us", "status", "iters", "lam"):
        assert torch.equal(getattr(rh, f), getattr(res, f)), f
    n = ilqr.max_iter_num
    assert hist.total.shape == (4, n + 1) and xs_hist.shape == (4, n + 1,
                                                                81, 6)
    assert torch.equal(hist.total[:, -1], res.cost.total)
    assert torch.equal(xs_hist[:, 0], res.init_xs)
    assert torch.equal(xs_hist[:, -1], res.xs)
    # a lane's history is flat once it concluded
    for b in range(4):
        k = int(res.iters[b])
        assert (hist.total[b, k:] == hist.total[b, -1]).all()
    # one problem unbatched is a batch of one
    r1 = TSo.solve(goals[1], starts[1], cons.map(lambda a: a[1]), ilqr,
                   veh, dt)
    assert r1.xs.shape == (81, 6) and r1.status.dim() == 0
    assert torch.equal(r1.us, res.us[1]) and torch.equal(r1.iters,
                                                         res.iters[1])
    h1 = TSo.solve_with_history(goals[1], starts[1],
                                cons.map(lambda a: a[1]), ilqr, veh, dt,
                                num_iters=5)[1]
    assert torch.equal(h1.total, hist.total[1, :6])


def test_vmap_backend_matches_blast(problem):
    goals, starts, cons, out = problem
    args = (goals, starts, cons, CFG.ilqr, CFG.vehicle, CFG.delta_t)
    rv = TB.solve_batch(*args, backend="vmap")
    rb = TB.solve_batch(*args, backend="blast")
    same = (rv.status == rb.status) & (rv.iters == rb.iters)
    assert int(same.sum()) >= 3, (rv.iters, rb.iters)
    # controls to fp-reassociation noise (batch-last sums, the kernels'
    # operation order on a card)
    assert float((rv.us - rb.us).abs().amax(dim=(1, 2))[same].max()) <= 1e-5
    # the closure, and a warm start through the vmap backend
    f = TB.solve_batch_jit(CFG, "vmap")
    assert torch.equal(f(goals, starts, cons).us, rv.us)
    rw = TB.solve_batch(*args, warm_start=(rv.xs, rv.us), backend="vmap")
    assert torch.equal(rw.init_us, rv.us)
    assert (rw.iters <= 2).all(), rw.iters


def test_pscan_backward_raises(problem):
    """backward_backend="pscan" selects the parallel scan (held against
    JAX in tests/test_torch_pscan.py) and the solve concludes on it."""
    from cilqr_tpu_torch import pscan

    goals, starts, cons, _ = problem
    cfg = dataclasses.replace(CFG.ilqr, backward_backend="pscan")
    assert TSo._select_backward(cfg) is pscan.backward_pass_pscan
    res = TSo.solve(goals[:1], starts[:1], cons.map(lambda a: a[:1]), cfg,
                    CFG.vehicle, CFG.delta_t)
    assert int(res.status[0]) != 0 and torch.isfinite(res.us).all()
