"""Per-knot math of the port against the JAX package, same inputs made
with numpy from a seed. Pure functions agree to round-off in float64
(rtol 1e-12): the two frameworks' CPU sin/cos/tan/log may differ by an
ulp. normalize_angle is bit-equal (torch.remainder == jnp.mod)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import barriers as JB
from cilqr_tpu import costs as JC
from cilqr_tpu import geometry as JG
from cilqr_tpu import model as JM
from cilqr_tpu import solver as JS
from cilqr_tpu.config import BarrierConfig, IlqrConfig, VehicleParam
from cilqr_tpu_torch import barriers as TB
from cilqr_tpu_torch import costs as TCo
from cilqr_tpu_torch import geometry as TG
from cilqr_tpu_torch import model as TM
from cilqr_tpu_torch import solver as TS
from cilqr_tpu_torch.convert import constraints_from_numpy

torch.set_num_threads(1)

VEH = VehicleParam()
DT = 0.1
RTOL = 1e-12


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _states(rng, n):
    x = rng.normal(size=(n, 6))
    x[:, 2] *= 4.0                 # headings well outside [-pi, pi)
    x[:, 3] = np.abs(x[:, 3]) * 5.0
    u = rng.normal(size=(n, 2)) * 0.3
    return x, u


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_normalize_angle_bit_equal(dtype):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-50, 50, 20000),
                        np.arange(-20, 21) * np.pi]).astype(dtype)
    got = TG.normalize_angle(torch.as_tensor(x)).numpy()
    want = np.asarray(JG.normalize_angle(jnp.asarray(x)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_point_segment_distance():
    rng = np.random.default_rng(1)
    p = rng.normal(size=(2, 500)) * 5
    a = rng.normal(size=(2, 500)) * 5
    b = a + rng.normal(size=(2, 500)) * 3
    b[:, :50] = a[:, :50]          # degenerate segments
    args = (p[0], p[1], a[0], a[1], b[0], b[1])
    got = TG.point_segment_distance(*(torch.as_tensor(v) for v in args))
    want = JG.point_segment_distance(*(jnp.asarray(v) for v in args))
    _close(got, want)


def test_dynamics_rk2():
    x, u = _states(np.random.default_rng(2), 400)
    got = TM.dynamics_rk2(torch.as_tensor(x), torch.as_tensor(u), DT,
                          VEH.wheel_base)
    want = JM.dynamics_rk2(jnp.asarray(x), jnp.asarray(u), DT,
                           VEH.wheel_base)
    _close(got, want)


def test_dynamics_jacobian_analytic():
    x, u = _states(np.random.default_rng(3), 400)
    A, B = TM.dynamics_jacobian_analytic(torch.as_tensor(x),
                                         torch.as_tensor(u), DT,
                                         VEH.wheel_base)
    Aj, Bj = JM.dynamics_jacobian_analytic(jnp.asarray(x), jnp.asarray(u),
                                           DT, VEH.wheel_base)
    assert A.shape == (400, 6, 6) and B.shape == (400, 6, 2)
    _close(A, Aj)
    _close(B, Bj)


def test_autodiff_jacobians_not_ported():
    """The autodiff mode, once not ported, now runs (torch.func.jacfwd):
    against JAX's jacfwd on random states, within 1e-12; an unknown mode
    raises."""
    x, u = _states(np.random.default_rng(6), 50)
    A, B = TM.dynamics_jacobian(torch.as_tensor(x), torch.as_tensor(u), DT,
                                VEH.wheel_base, mode="autodiff")
    Aj, Bj = JM.dynamics_jacobian(jnp.asarray(x), jnp.asarray(u), DT,
                                  VEH.wheel_base, mode="autodiff")
    assert A.shape == (50, 6, 6) and B.shape == (50, 6, 2)
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(B.numpy(), np.asarray(Bj), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="jacobian mode"):
        TM.dynamics_jacobian(torch.as_tensor(x), torch.as_tensor(u), DT,
                             VEH.wheel_base, mode="numeric")


def test_rollout():
    x, u = _states(np.random.default_rng(4), 30)
    got = TM.rollout(torch.as_tensor(x[0]), torch.as_tensor(u), DT,
                     VEH.wheel_base)
    want = JM.rollout(jnp.asarray(x[0]), jnp.asarray(u), DT, VEH.wheel_base)
    _close(got, want, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("kind", ["relax", "exponential", "quadratic"])
def test_barriers(kind):
    rng = np.random.default_rng(5)
    g = np.concatenate([rng.uniform(-3, 1, 4000),
                        [-0.01, -0.0100001, 0.0, 1e-10, 2e-10]])
    cfg = BarrierConfig(kind=kind)
    tb, jb = TB.make_barrier(cfg), JB.make_barrier(cfg)
    gt, gj = torch.as_tensor(g), jnp.asarray(g)
    _close(tb.value(gt), jb.value(gj))
    _close(tb.grad_factor(gt), jb.grad_factor(gj))
    for a, b in zip(tb.hess_factors(gt), jb.hess_factors(gj)):
        _close(a, b)
    assert torch.isfinite(tb.value(gt)).all()


def _raw_constraints(rng, B=3, N=7, KC=10, S=12):
    planes = rng.normal(size=(B, N, KC, 3))
    mask = rng.uniform(size=(B, N, KC)) < 0.6
    mask[..., KC - 2:] = False     # unused padded slots
    lp = rng.normal(size=(B, S, 3))
    rp = rng.normal(size=(B, S, 3))
    segs = rng.normal(size=(B, S, 2, 2))
    lm = np.arange(S)[None].repeat(B, 0) < 5
    rm = np.arange(S)[None].repeat(B, 0) < 3
    return (planes, mask, lp, segs, lm, rp, segs + 1.0, rm)


def test_shrink_tighten_trim():
    cfg = IlqrConfig()
    raw = _raw_constraints(np.random.default_rng(6))
    jc = JC.shrink_and_normalize(*(jnp.asarray(a) for a in raw), cfg, VEH)
    tc = TCo.shrink_and_normalize(
        *(torch.as_tensor(a) for a in raw), cfg, VEH)
    for a, b in zip(tc, jc):
        _close(a, b)
    jt = JC.tighten_constraints(jc, 0.35)
    tt = TCo.tighten_constraints(tc, 0.35)
    for a, b in zip(tt, jt):
        _close(a, b)
    jr = JC.trim_constraints(jc)
    tr = TCo.trim_constraints(tc)
    for a, b in zip(tr, jr):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


def test_iqr_init_and_transform_goals():
    from cilqr_tpu_torch.convert import load_fixture

    g, s, _ = load_fixture(dtype=torch.float64, device="cpu")
    g, s = g[:8], s[:8]
    cfg = IlqrConfig()
    gt = TS.transform_goals(g, s)
    gj = jax.vmap(JS.transform_goals)(jnp.asarray(g.numpy()),
                                      jnp.asarray(s.numpy()))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    xs, us = TS.iqr_init(gt, cfg, VEH, DT)
    xj, uj = jax.vmap(lambda q: JS.iqr_init(q, cfg, VEH, DT))(gj)
    _close(us, uj, rtol=1e-9, atol=1e-10)
    _close(xs, xj, rtol=1e-9, atol=1e-10)


def test_constraints_from_numpy_keeps_masks_bool():
    raw = _raw_constraints(np.random.default_rng(7))
    cons = constraints_from_numpy(raw, torch.float32, "cpu")
    assert cons.corridor_mask.dtype == torch.bool
    assert cons.left_planes.dtype == torch.float32
