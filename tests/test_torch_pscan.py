"""The port's horizon-parallel backward pass (cilqr_tpu_torch/pscan.py)
against the JAX package and its own sequential sweeps, float64 on the
CPU: tests/test_pscan.py's four cases on the port, each also held to the
JAX package's function on the same inputs (jitted: one compile each).

Tolerances: the combine against direct composition of the two maps
within 1e-9 (rtol and atol, as tests/test_pscan.py); the scan against the
port's sequential Woodbury sweep and against JAX's scan within 1e-8 at
any lambda (its own order of sums: the odd/even tree of
jax.lax.associative_scan, 6x6 solves by torch.linalg.solve); against the
reference sweep at lambda 0 within 1e-7; the solve with
backward_backend="pscan" on tests/test_pscan.py's three problems against
JAX's: status and iterations identical on every lane, controls within
1e-6; and against the port's "scan" backend as tests/test_pscan.py holds
JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import batch as JB
from cilqr_tpu import pscan as JPs
from cilqr_tpu.config import PlannerConfig as JPlannerConfig
from cilqr_tpu_torch import batch as TB
from cilqr_tpu_torch import pscan as TPs
from cilqr_tpu_torch.config import PlannerConfig
from cilqr_tpu_torch.costs import ConstraintSet
from cilqr_tpu_torch.solver import backward_pass
from cilqr_tpu_torch.types import SolverStatus

from test_solver_blast import _batch_from_problems

F64 = torch.float64


def _random_problem(rng, T=80, n=6, m=2):
    """Random well-conditioned LQR data shaped like the solver's, numpy."""
    A = np.eye(n) + 0.05 * rng.standard_normal((T, n, n))
    B = 0.1 * rng.standard_normal((T, n, m))
    Jx = rng.standard_normal((T + 1, n))
    Ju = rng.standard_normal((T, m))
    Hs = rng.standard_normal((T + 1, n, n))
    Hx = Hs @ np.swapaxes(Hs, 1, 2) * 0.1 + np.eye(n) * 0.5
    Hu = np.broadcast_to(np.diag([0.4, 0.1]), (T, m, m)).copy()
    return A, B, Jx, Ju, Hx, Hu


def _t(prob):
    return [torch.tensor(p)[None] for p in prob]


def _lam(v):
    return torch.tensor([v], dtype=F64)


def _apply(elem, v, M):
    """One element map, the definition the combine must preserve."""
    P, b, C, eta, J = elem
    eye = np.eye(P.shape[0])
    return (eta + P.T @ np.linalg.solve(eye + M @ C, v + M @ b),
            J + P.T @ M @ np.linalg.solve(eye + C @ M, P))


def test_combine_matches_direct_composition():
    rng = np.random.default_rng(0)
    n = 6
    for _ in range(5):
        def mk():
            s1, s2 = rng.standard_normal((2, n, n))
            return (np.eye(n) + 0.1 * rng.standard_normal((n, n)),
                    rng.standard_normal(n), s1 @ s1.T * 0.1,
                    rng.standard_normal(n), s2 @ s2.T * 0.1 + np.eye(n))

        early, late = mk(), mk()
        v = rng.standard_normal(n)
        M0 = rng.standard_normal((n, n))
        M = M0 @ M0.T * 0.1 + np.eye(n) * 0.3
        v_ref, M_ref = _apply(early, *_apply(late, v, M))
        comb = [c.numpy() for c in TPs._combine(
            [torch.tensor(e) for e in late], [torch.tensor(e) for e in early])]
        v_c, M_c = _apply(comb, v, M)
        np.testing.assert_allclose(M_c, M_ref, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(v_c, v_ref, rtol=1e-9, atol=1e-9)
        want = jax.jit(JPs._combine)(tuple(map(jnp.asarray, late)),
                                     tuple(map(jnp.asarray, early)))
        for g, w in zip(comb, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12,
                                       atol=1e-12)


def test_pscan_matches_sequential_woodbury_any_lambda():
    prob = _random_problem(np.random.default_rng(1))
    j_pscan = jax.jit(JPs.backward_pass_pscan)
    j_seq = jax.jit(JPs.backward_pass_woodbury_seq)
    for lam in (0.0, 1e-3, 1.0, 100.0):
        got = TPs.backward_pass_pscan(_lam(lam), *_t(prob))
        seq = TPs.backward_pass_woodbury_seq(_lam(lam), *_t(prob))
        want = j_pscan(jnp.float64(lam), *map(jnp.asarray, prob))
        jseq = j_seq(jnp.float64(lam), *map(jnp.asarray, prob))
        for g, s, w, js in zip(got, seq, want, jseq):
            np.testing.assert_allclose(g[0].numpy(), s[0].numpy(),
                                       rtol=1e-8, atol=1e-8)
            np.testing.assert_allclose(g[0].numpy(), np.asarray(w),
                                       rtol=1e-8, atol=1e-8)
            np.testing.assert_allclose(s[0].numpy(), np.asarray(js),
                                       rtol=1e-10, atol=1e-10)
    # the value functions at every knot, against JAX's
    V = TPs.value_functions(_lam(0.5), *_t(prob))
    JV = jax.jit(JPs.value_functions)(jnp.float64(0.5),
                                      *map(jnp.asarray, prob))
    for g, w in zip(V, JV):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-8)


def test_pscan_matches_reference_backward_at_lambda_zero():
    prob = _random_problem(np.random.default_rng(2))
    # a batch of two lanes: the scan is batched over its leading axis
    two = [torch.cat([p, p * 1.0]) for p in _t(prob)]
    got = TPs.backward_pass_pscan(torch.zeros(2, dtype=F64), *two)
    ref = backward_pass(torch.zeros(2, dtype=F64), *two)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-7,
                                   atol=1e-8)
        assert torch.equal(g[0], g[1])


@pytest.fixture(scope="module")
def problems():
    """tests/test_pscan.py's problems, on both sides."""
    jg, js, jc = _batch_from_problems(range(3))

    def t(a):
        a = np.asarray(a)
        return torch.tensor(a) if a.dtype == np.bool_ else torch.tensor(
            a, dtype=F64)

    return (jg, js, jc), (t(jg), t(js), ConstraintSet(*map(t, jc)))


def test_solve_with_pscan_backend(problems):
    """The vmap backend with the pscan backward against JAX's on the same
    problems; and against the "scan" backend as tests/test_pscan.py holds
    JAX's (the two lambda placements take different iterate paths, so
    controls agree to the solver's own stopping tolerance; with lambda
    held at its floor they coincide to round-off)."""
    (jg, js, jc), (goals, starts, cons) = problems
    cfg, jcfg = PlannerConfig(), JPlannerConfig()
    veh, dt = cfg.vehicle, cfg.delta_t
    par = dataclasses.replace(cfg.ilqr, backward_backend="pscan")
    seq = dataclasses.replace(cfg.ilqr, backward_backend="scan")
    r_par = TB.solve_batch(goals, starts, cons, par, veh, dt, backend="vmap")
    jres = JB.solve_batch(
        jg, js, jc, dataclasses.replace(jcfg.ilqr, backward_backend="pscan"),
        jcfg.vehicle, jcfg.delta_t, backend="vmap")
    np.testing.assert_array_equal(r_par.status.numpy(),
                                  np.asarray(jres.status))
    np.testing.assert_array_equal(r_par.iters.numpy(), np.asarray(jres.iters))
    assert np.abs(r_par.us.numpy() - np.asarray(jres.us)).max() <= 1e-6

    r_seq = TB.solve_batch(goals, starts, cons, seq, veh, dt, backend="vmap")
    assert (r_par.status != SolverStatus.FAIL_LAMBDA_MAX).all()
    np.testing.assert_allclose(r_par.us.numpy(), r_seq.us.numpy(),
                               atol=1.5e-2)
    np.testing.assert_allclose(r_par.cost.total.numpy(),
                               r_seq.cost.total.numpy(), atol=1.0)
    reg0 = dataclasses.replace(par.reg, lambda_init=par.reg.lambda_min)
    r_par0 = TB.solve_batch(goals, starts, cons,
                            dataclasses.replace(par, reg=reg0), veh, dt,
                            backend="vmap")
    r_seq0 = TB.solve_batch(goals, starts, cons,
                            dataclasses.replace(seq, reg=reg0), veh, dt,
                            backend="vmap")
    quiet = (r_seq0.lam <= 1e-6) & (r_par0.lam <= 1e-6)
    assert quiet.any()
    np.testing.assert_allclose(r_par0.us[quiet].numpy(),
                               r_seq0.us[quiet].numpy(), rtol=1e-6,
                               atol=1e-6)
