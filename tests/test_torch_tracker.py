"""The port's lqr.solve_lqr and tracker.plan against scipy, the numpy
transcription oracle of the reference (tests/tracker_oracle.py) and the JAX
package, float64 on the CPU; and the tracker initial guess through the
port's plan_batch.

Tolerances:
- solve_lqr: the DARE gain against scipy's direct solution at rtol 1e-6
  (as tests/test_tracker.py); against JAX's solve_lqr within 1e-12, with
  each problem's stopping iteration equal to the reference's loop's
  (a numpy transcription of linear_quadratic_regulator.cc:30-79);
- tracker.plan, batched over three starts: against the oracle at atol
  1e-8 (states) / 1e-7 (controls), as tests/test_tracker.py; against JAX's
  tracker.plan (vmapped, one jit) within 1e-9;
- plan_batch(init_guess="tracker"): the solve's initial trajectory is the
  tracker rollout of the replan's coarse plan, bit for bit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracker_oracle
from cilqr_tpu import lqr as JL
from cilqr_tpu import tracker as JT
from cilqr_tpu.config import PlannerConfig as JPlannerConfig
from cilqr_tpu.types import Traj as JTraj
from cilqr_tpu_torch import lqr as TL
from cilqr_tpu_torch import pipeline as TP
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch import tracker as TT
from cilqr_tpu_torch.config import PlannerConfig
from cilqr_tpu_torch.solver import iqr_init, transform_goals
from cilqr_tpu_torch.types import SolverStatus, Traj

CFG = PlannerConfig()
JCFG = JPlannerConfig()
F64 = torch.float64


def _lon_problem(cfg=CFG.tracker):
    dt = cfg.dt
    A = np.eye(3)
    A[0, 1] = dt
    A[1, 2] = -dt
    B = np.zeros((3, 1))
    B[2, 0] = dt
    Q = np.diag([cfg.lon_weight_s, cfg.lon_weight_v, cfg.lon_weight_a])
    return A, B, Q, np.array([[cfg.lon_weight_j]])


def _lat_problems(speeds, cfg=CFG.tracker, L=CFG.vehicle.wheel_base):
    A = np.tile(np.eye(3), (len(speeds), 1, 1))
    va = np.maximum(2.0, np.asarray(speeds))
    A[:, 0, 1] = va * cfg.dt
    A[:, 1, 2] = -va / L * cfg.dt
    B = np.zeros((3, 1))
    B[2, 0] = cfg.dt
    Q = np.diag([cfg.lat_weight_l, cfg.lat_weight_theta,
                 cfg.lat_weight_delta])
    return A, B, Q, np.array([[cfg.lat_weight_delta_rate]])


def _reference_iterations(A, B, Q, R, tol, max_iter, M=None):
    """The iterations math::SolveLQRProblem runs (its loop,
    linear_quadratic_regulator.cc:44-57, |max coefficient| stop)."""
    M = np.zeros((A.shape[0], B.shape[1])) if M is None else M
    P, n, diff = Q.copy(), 0, np.inf
    while n < max_iter and diff > tol:
        n += 1
        P_next = (A.T @ P @ A - (A.T @ P @ B + M) @ np.linalg.inv(
            R + B.T @ P @ B) @ (B.T @ P @ A + M.T) + Q)
        diff = abs(np.max(P_next - P))
        P = P_next
    return n


def test_lqr_gain_matches_scipy_dare():
    from scipy.linalg import solve_discrete_are

    A, B, Q, R = _lon_problem()
    K = TL.solve_lqr(*(torch.tensor(v) for v in (A, B, Q, R)), 1e-10, 5000)
    P = solve_discrete_are(A, B, Q, R)
    want = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
    np.testing.assert_allclose(K.numpy(), want, rtol=1e-6, atol=1e-8)


def test_lqr_matches_jax_and_reference_iterations():
    """Batched: the tracker's lateral problems at speeds across its range
    (the stop is per problem), the longitudinal one, and a random
    two-control problem with a cross term M; each against JAX's solve_lqr
    on the same problem."""
    tol, max_iter = CFG.tracker.tolerance, CFG.tracker.max_num_iteration
    speeds = [0.0, 1.0, 2.0, 3.5, 5.0, 7.0, 10.0, 12.5, 15.0, 20.0]
    A, B, Q, R = _lat_problems(speeds)
    At, Bt, Qt, Rt = (torch.tensor(v) for v in (A, B, Q, R))
    K = TL.solve_lqr(At, Bt, Qt, Rt, tol, max_iter)
    _, it = TL.riccati_fixed_point(At, Bt, Qt, Rt, torch.zeros(3, 1,
                                                               dtype=F64),
                                   tol, max_iter)
    want = jax.vmap(lambda a: JL.solve_lqr(a, jnp.asarray(B), jnp.asarray(Q),
                                           jnp.asarray(R), tol, max_iter))(
        jnp.asarray(A))
    np.testing.assert_allclose(K.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    assert it.tolist() == [_reference_iterations(a, B, Q, R, tol, max_iter)
                           for a in A]
    assert len(set(it.tolist())) > 2          # stops differ across lanes

    rng = np.random.default_rng(4)
    A2 = np.eye(4) + 0.1 * rng.normal(size=(4, 4))
    B2 = rng.normal(size=(4, 2))
    Q2 = np.diag(rng.uniform(0.5, 2.0, 4))
    R2 = np.diag(rng.uniform(0.5, 2.0, 2))
    M2 = 0.05 * rng.normal(size=(4, 2))
    for args, m in (((A2, B2, Q2, R2), M2), (_lon_problem(), None)):
        targs = [torch.tensor(v) for v in args]
        tm = torch.zeros(targs[1].shape, dtype=F64) if m is None \
            else torch.tensor(m)
        K = TL.solve_lqr(*targs, tol, max_iter, M=tm)
        _, it = TL.riccati_fixed_point(*targs, tm, tol, max_iter)
        want = JL.solve_lqr(*(jnp.asarray(v) for v in args), tol, max_iter,
                            M=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(K.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
        assert int(it) == _reference_iterations(*args, tol, max_iter, M=m)


def _curved_coarse(n=81, v=8.0, dt=0.1, radius=40.0):
    """Constant-speed arc (tests/test_tracker.py's): real curvature, so the
    preview projection, slerp and the lateral LQR all do work."""
    t = np.arange(n) * dt
    s = v * t
    th = s / radius
    z = np.zeros(n)
    return dict(time=t, s=s, x=radius * np.sin(th),
                y=radius * (1.0 - np.cos(th)), theta=th,
                kappa=np.full(n, 1.0 / radius), velocity=np.full(n, v),
                left_bound=z, right_bound=z, a=z, jerk=z,
                delta=np.full(n, math.atan(CFG.vehicle.wheel_base / radius)),
                delta_rate=z)


def test_tracker_matches_oracle_and_jax():
    coarse = _curved_coarse()
    starts = np.array([[0.3, -0.4, 0.1, 7.0, 0.2, 0.02],
                       [0.0, 0.0, 0.0, 10.0, 0.0, 0.0],
                       [-0.5, 0.8, -0.15, 1.5, -0.3, -0.05]])
    tc = Traj(**{f: torch.tensor(v).expand(3, -1)
                 for f, v in coarse.items()})
    xs, us = TT.plan(torch.tensor(starts), tc, CFG.tracker, CFG.vehicle)
    assert xs.shape == (3, 81, 6) and us.shape == (3, 80, 2)
    jc = JTraj(**{f: jnp.asarray(v) for f, v in coarse.items()})
    jxs, jus = jax.jit(jax.vmap(lambda s: JT.plan(
        s, jc, JCFG.tracker, JCFG.vehicle)))(jnp.asarray(starts))
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), rtol=0,
                               atol=1e-9)
    oracle = tracker_oracle.TrackerOracle(JCFG.tracker, JCFG.vehicle)
    for b in range(3):
        want_xs, want_us = oracle.plan(starts[b], jc)
        np.testing.assert_allclose(xs[b].numpy(), want_xs, atol=1e-8)
        np.testing.assert_allclose(us[b].numpy(), want_us, atol=1e-7)
    veh = CFG.vehicle
    assert (us[..., 0] >= veh.jerk_min - 1e-12).all()
    assert (us[..., 1] <= veh.delta_rate_max + 1e-12).all()
    np.testing.assert_array_equal(xs[:, 0].numpy(), starts)


def test_plan_batch_tracker_init_guess(monkeypatch):
    """init_guess="tracker" routes the tracker rollout of each lane's
    coarse plan, from its start state, into the solve as its initial
    trajectory."""
    cfg = dataclasses.replace(CFG, ilqr=dataclasses.replace(
        CFG.ilqr, init_guess="tracker", compaction_phase1=0))
    calls = []
    real = TT.plan

    def plan(start, coarse, tcfg, veh):
        out = real(start, coarse, tcfg, veh)
        calls.append((start, coarse, out))
        return out

    monkeypatch.setattr(TT, "plan", plan)
    seeds = (0, 1)
    scn = TS.make_scenario_batch(seeds, dtype=F64, device="cpu")
    spec = TS.analytic_road_spec(dtype=np.float64)
    starts = torch.tensor([[0.0, 0.0, 0.0, 10.0], [0.0, 0.3, 0.05, 9.0]],
                          dtype=F64)
    out = TP.plan_batch(scn, starts, cfg, None, None, spec=spec)
    assert len(calls) == 1
    start6, coarse, (want_xs, want_us) = calls[0]
    assert torch.equal(start6, TP.start_states(starts, F64))
    assert torch.equal(coarse.x, out.coarse.x)
    assert torch.equal(coarse.time, out.coarse.time)
    assert not out.pre_hits[:, :TP.NEAR_TERM_KNOTS].any()
    assert torch.equal(out.solve.init_xs, want_xs)
    assert torch.equal(out.solve.init_us, want_us)
    assert (out.solve.status != SolverStatus.RUNNING).all()
    assert torch.isfinite(out.solve.xs).all()
    # a tracking rollout from the start: knot 0 is the start state, and
    # the guess is not the LQR one
    assert torch.equal(want_xs[:, 0], start6)
    goals = transform_goals(TP.coarse_to_states(out.coarse), start6)
    lqr_xs, _ = iqr_init(goals, cfg.ilqr, cfg.vehicle, cfg.delta_t)
    assert (lqr_xs - want_xs).abs().max() > 1e-3


def test_unknown_init_guess_raises():
    cfg = dataclasses.replace(CFG, ilqr=dataclasses.replace(
        CFG.ilqr, init_guess="lqr"))
    with pytest.raises(ValueError, match="init_guess"):
        TP._init_guess_warm_start(cfg, torch.zeros(6, dtype=F64),
                                  Traj.zeros(81, F64, "cpu"))
