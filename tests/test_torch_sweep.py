"""The sweep kernel's plain version and the solver's sweep twins against
the JAX package, on the CPU.

riccati_sweep_ref is held against the Pallas kernel in interpret mode
(tests/test_pallas_sweep.py's shapes and problems: T=20, B=128), and
_backward_bl/_forward_bl against their JAX counterparts, all in float64.
Tolerance 1e-10 (scaled by 1 + |ref|): the two frameworks reduce the
6x6 products in another order and their CPU sin/cos/tan differ by an ulp.
Rollouts are compared one step at a time (see _teacher_forced)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import solver_blast as JSB
from cilqr_tpu.pallas.sweep import riccati_sweep as jax_riccati_sweep
from cilqr_tpu_torch import solver_blast as TSB
from cilqr_tpu_torch.kernels import sweep as TSW

from test_pallas_sweep import T, _random_problem

torch.set_num_threads(1)

TOL = 1e-10
DT, L = 0.1, 1.0


def _close(got, want, tol=TOL):
    got = np.asarray(got)
    want = np.asarray(want)
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= tol, float(err.max())


def _inputs(seed):
    jx = _random_problem(seed)
    tx = tuple(torch.as_tensor(np.array(a)) for a in jx)
    return jx, tx


def _teacher_forced(nxs, nus, alpha, Ks, ks, xs, us):
    """From every state of a rollout (nxs [N,6,B], nus [T,2,B]), the
    kernel's plain step with the same gains and alpha must give the next
    control and state. Free-running rollouts are not compared: on these
    random problems some lanes' closed loops are chaotic, so round-off in
    the gains grows to ~1e-5 by T=20 (the JAX package's own twin and
    kernel differ by 3e-4 on lane 78 of seed 1)."""
    for t in range(us.shape[0]):
        u, x = TSW._forward_step_ref(torch.as_tensor(np.array(nxs[t])), t,
                                     alpha, Ks, ks, xs, us, DT, L)
        _close(u, nus[t])
        _close(x, nxs[t + 1])


@pytest.mark.parametrize("ka", [1, 3])
def test_sweep_ref_matches_pallas_interpret(ka):
    """riccati_sweep_ref against the Pallas kernel (interpret mode): the
    backward outputs directly, the rollouts step by step."""
    (lam, alpha, A, Bm, Jx, Ju, Hx, Hu, xs_cm, us_cm), t = _inputs(ka)
    if ka == 1:
        alphas = alpha
    else:
        rng = np.random.default_rng(ka + 1)
        alphas = jnp.asarray(rng.uniform(0.1, 1.0, (ka,) + alpha.shape))
    xs_km = jnp.moveaxis(xs_cm, 0, 1)
    us_tm = jnp.moveaxis(us_cm, 0, 1)
    want = jax_riccati_sweep(lam, alphas, A, Bm, Jx, Ju, Hx, Hu, xs_km,
                             us_tm, dt=DT, wheel_base=L, interpret=True)
    targs = [torch.as_tensor(np.array(a)) for a in
             (lam, alphas, A, Bm, Jx, Ju, Hx, Hu, xs_km, us_tm)]
    got = TSW.riccati_sweep_ref(*targs, dt=DT, wheel_base=L)
    for g, w in zip(got[2:], want[2:]):      # dV0, dV1, gnorm
        _close(g, w)
    Ks, ks = TSW._backward_ref(*targs[:1], *targs[2:8], targs[9])[:2]
    if ka == 1:
        assert tuple(got[0].shape) == (T + 1, 6, 128)
        _teacher_forced(want[0], want[1], targs[1], Ks, ks, targs[8],
                        targs[9])
    else:
        assert len(got[0]) == ka and len(got[1]) == ka
        for a in range(ka):
            assert tuple(got[1][a].shape) == (T, 2, 128)
            _teacher_forced(want[0][a], want[1][a], targs[1][a], Ks, ks,
                            targs[8], targs[9])


def test_sweep_wrapper_on_cpu_is_the_plain_version():
    _, (lam, alpha, A, Bm, Jx, Ju, Hx, Hu, xs_cm, us_cm) = _inputs(4)
    args = (lam, torch.stack([alpha, 0.5 * alpha]), A, Bm, Jx, Ju, Hx, Hu,
            xs_cm.movedim(0, 1), us_cm.movedim(0, 1))
    before = TSW.riccati_sweep.launches
    got = TSW.riccati_sweep(*args, dt=DT, wheel_base=L)
    want = TSW.riccati_sweep_ref(*args, dt=DT, wheel_base=L)
    assert TSW.riccati_sweep.launches == before
    for g, w in zip(got[0] + got[1] + got[2:], want[0] + want[1] + want[2:]):
        assert torch.equal(g, w)


def test_backward_forward_twins_match_jax():
    """_backward_bl directly; _forward_bl one step from each state of the
    JAX rollout (all steps at once: step t of lane b is lane t*B + b)."""
    (lam, alpha, A, Bm, Jx, Ju, Hx, Hu, xs_cm, us_cm), tx = _inputs(5)
    Ks_j, ks_j, dV0_j, dV1_j = JSB._backward_bl(lam, A, Bm, Jx, Ju, Hx, Hu)
    Ks_t, ks_t, dV0_t, dV1_t = TSB._backward_bl(tx[0], *tx[2:8])
    for g, w in ((Ks_t, Ks_j), (ks_t, ks_j), (dV0_t, dV0_j),
                 (dV1_t, dV1_j)):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)
    nxs_j, nus_j = JSB._forward_bl(alpha, xs_cm, us_cm, Ks_j, ks_j, xs_cm,
                                   DT, L)
    B = lam.shape[0]

    def fold(v):          # [..., T, B] -> [..., 1, T*B]
        return v.reshape(v.shape[:-2] + (1, T * B))

    x_j = torch.as_tensor(np.array(nxs_j))
    u_j = torch.as_tensor(np.array(nus_j))
    xs_t, us_t = tx[8], tx[9]
    nx1, nu1 = TSB._forward_bl(
        tx[1].repeat(T), torch.cat([fold(xs_t[:, :T]), fold(xs_t[:, 1:])], 1),
        fold(us_t), Ks_t.permute(1, 2, 0, 3).reshape(1, 2, 6, T * B),
        ks_t.permute(1, 0, 2).reshape(1, 2, T * B), fold(x_j[:, :T]), DT, L)
    _close(nu1[:, 0].reshape(2, T, B), u_j)
    _close(nx1[:, 1].reshape(6, T, B), x_j[:, 1:])
    # the free run's shapes and first steps (before any chaotic growth)
    nxs_t, nus_t = TSB._forward_bl(tx[1], xs_t, us_t, Ks_t, ks_t, xs_t, DT, L)
    assert tuple(nxs_t.shape) == (6, T + 1, B)
    _close(nxs_t[:, :8], np.asarray(nxs_j)[:, :8])


def test_sweep_ref_matches_twins():
    """The kernel's plain version and the solver's twins compute the same
    sweep (they differ only in the angle-wrap formula)."""
    _, (lam, alpha, A, Bm, Jx, Ju, Hx, Hu, xs_cm, us_cm) = _inputs(6)
    nxs, nus, dV0, dV1, gnorm = TSW.riccati_sweep_ref(
        lam, alpha, A, Bm, Jx, Ju, Hx, Hu, xs_cm.movedim(0, 1),
        us_cm.movedim(0, 1), dt=DT, wheel_base=L)
    Ks, ks, dV0_t, dV1_t = TSB._backward_bl(lam, A, Bm, Jx, Ju, Hx, Hu)
    gnorm_t = (ks.abs() / (us_cm.movedim(1, 0).abs() + 1.0)).amax(1).mean(0)
    nxs_t, nus_t = TSB._forward_bl(alpha, xs_cm, us_cm, Ks, ks, xs_cm, DT, L)
    _close(dV0, dV0_t)
    _close(dV1, dV1_t)
    _close(gnorm, gnorm_t)
    _teacher_forced(nxs_t.movedim(0, 1), nus_t.movedim(0, 1), alpha, Ks, ks,
                    xs_cm.movedim(0, 1), us_cm.movedim(0, 1))
    assert tuple(nxs.shape) == (T + 1, 6, lam.shape[0])
