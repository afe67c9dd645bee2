"""The cost-stack kernel's plain version, the solver's cost stack and the
lane windows against the JAX package, on the CPU.

corridor_lane_stack_ref, on the kernel's operands from the port's
cons_to_bl, is held against the Pallas kernel in interpret mode (on JAX's
windowed operands) on tests/test_coststack_kernel.py's synthetic problem
(B=128, 21 knots, lane_window=4); the port's plain _cost_stack_bl against
JAX's on that problem and on fixture problems (W=32 windows). The kernel's
operands imply exactly cons_to_bl's windows, and the plain version on them
is bit for bit the windowed math on those windows. Tolerances are stated
per test: float64 agrees to round-off (1e-10 scaled by 1 + |ref|; the
frameworks' CPU sin/cos/log may differ by an ulp); float32 to 1e-4."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import solver_blast as JSB
from cilqr_tpu.costs import ConstraintSet as JConstraintSet
from cilqr_tpu.costs import trim_constraints as jax_trim
from cilqr_tpu.pallas.coststack import corridor_lane_stack as jax_stack
from cilqr_tpu_torch import profiling as TPr
from cilqr_tpu_torch import solver_blast as TSB
from cilqr_tpu_torch.convert import (FIXTURE, constraints_from_numpy,
                                     load_fixture)
from cilqr_tpu_torch.costs import trim_constraints
from cilqr_tpu_torch.kernels import coststack as TCS

from __graft_entry__ import _synthetic_problem

torch.set_num_threads(1)

TOLS = {np.float64: 1e-10, np.float32: 1e-4}
TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= tol, float(err.max())


def _torch_cbl(cbl):
    """Convert a JAX ConsBL to torch tensors (masks stay bool)."""
    conv = (lambda a: None if a is None
            else torch.as_tensor(np.array(a)))
    return TSB.ConsBL(
        ca=conv(cbl.ca), cb=conv(cbl.cb), cc=conv(cbl.cc), cm=conv(cbl.cm),
        lanes=tuple(tuple(conv(v) for v in side) for side in cbl.lanes))


def _synthetic(dtype):
    cfg, goals, starts, cons = _synthetic_problem(128, 21, dtype)
    goals_bl = JSB._bl(goals)
    cbl = JSB.cons_to_bl(cons, goals_bl=goals_bl, lane_window=4)
    rng = np.random.default_rng(0)
    xs = goals_bl + jnp.asarray(rng.normal(0, 0.05, goals_bl.shape), dtype)
    us = jnp.asarray(rng.normal(0, 0.1, (2, 20, 128)), dtype)
    return cfg, xs, us, goals_bl, cbl


def _synthetic_torch(dtype):
    """The synthetic problem through the port's cons_to_bl (lane_window=4):
    (cfg, xs, ConsBL with the kernel's operands), torch on the CPU."""
    cfg, goals, _, cons = _synthetic_problem(128, 21, dtype)
    tcons = constraints_from_numpy(cons, TORCH_DTYPE[dtype], "cpu")
    goals_bl = torch.as_tensor(np.array(JSB._bl(goals)))
    rng = np.random.default_rng(0)
    xs = goals_bl + torch.as_tensor(rng.normal(0, 0.05, goals_bl.shape)
                                    .astype(dtype))
    return cfg, xs, TSB.cons_to_bl(tcons, goals_bl=goals_bl, lane_window=4)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("want_derivs", [False, True])
def test_stack_ref_matches_pallas_interpret(want_derivs, dtype):
    cfg, xs, _, _, cbl = _synthetic(dtype)
    args = (TSB.kernel_disc_offsets(cfg.ilqr, cfg.vehicle),
            cfg.ilqr.barrier.t, cfg.ilqr.barrier.epsilon)
    want = jax_stack(xs, (cbl.ca, cbl.cb, cbl.cc, cbl.cm), cbl.lanes, *args,
                     want_derivs=want_derivs, interpret=True)
    _, xt, tb = _synthetic_torch(dtype)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xs))
    got = TCS.corridor_lane_stack_ref(xt, tb.stack, *args,
                                      want_derivs=want_derivs)
    assert len(got) == (12 if want_derivs else 3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got, want):
        _close(g, w, TOLS[dtype])
    # the CPU wrapper is the plain version, and launches nothing
    before = TPr.counters["corridor_lane_stack.launches"]
    again = TCS.corridor_lane_stack(xt, tb.stack, *args,
                                    want_derivs=want_derivs)
    assert TPr.counters["corridor_lane_stack.launches"] == before
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _fixture_torch(dtype, lane_window, right_s=None):
    """16 fixture problems through the port's cons_to_bl, the right side
    cut to its first right_s segments if given: (cfg, xs, ConsBL), xs moved
    metres off the goals so that selections reach the window edges."""
    from cilqr_tpu_torch.config import PlannerConfig
    from cilqr_tpu_torch.solver import transform_goals

    cfg = PlannerConfig()
    g, s, cons = load_fixture(dtype=TORCH_DTYPE[dtype], device="cpu")
    g, s, cons = g[:16], s[:16], cons.map(lambda a: a[:16])
    if right_s is not None:
        cons = cons._replace(right_planes=cons.right_planes[:, :right_s],
                             right_segs=cons.right_segs[:, :right_s],
                             right_mask=cons.right_mask[:, :right_s])
    goals = TSB._bl(transform_goals(g, s))
    cbl = TSB.cons_to_bl(cons, goals_bl=goals, lane_window=lane_window)
    rng = np.random.default_rng(1)
    xs = goals.clone()
    xs[:3] += torch.as_tensor(rng.normal(0, 5.0, (3,) + goals.shape[1:])
                              .astype(dtype))
    return cfg, xs, cbl


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("problem, lane_window, right_s", [
    ("synthetic", 4, None), ("fixture", 32, None), ("fixture", 8, None),
    ("fixture", 8, 24)])
def test_stack_operands_are_the_windows(problem, lane_window, right_s,
                                        dtype):
    """cons_to_bl's kernel operands (each side's segments once, window
    starts) imply exactly its windowed tensors, and the plain version on
    them equals, bit for bit, the windowed math on those windows: every
    row, the clip flags and the lane selection. W=8 makes lo and hi both
    true; right_s=24 gives the sides 40 and 24 segments, the shorter padded
    with masked ones."""
    if problem == "synthetic":
        cfg, xs, cbl = _synthetic_torch(dtype)
    else:
        cfg, xs, cbl = _fixture_torch(dtype, lane_window, right_s)
    ops = cbl.stack
    N, B = xs.shape[1:]
    S = ops.segs.shape[2]
    if right_s is not None:
        assert S == 40 and not bool(ops.segs[1, :, right_s:].any())
    assert ops.W == lane_window
    assert tuple(ops.corr.shape) == (4, N, cbl.ca.shape[1], B)
    assert tuple(ops.segs.shape) == (2, 8, S, B)
    assert ops.start.dtype == torch.int32 and ops.segs.dtype == xs.dtype
    assert all(v.is_contiguous() for v in ops[:4])
    # the corridor rows are views of the operand, not copies
    assert cbl.ca.data_ptr() == ops.corr[0].data_ptr()
    for implied, windowed in zip(TCS.window_lanes(ops), cbl.lanes):
        for u, v in zip(implied, windowed):
            assert torch.equal(u, v.to(u.dtype))
    if lane_window == 8:
        assert bool(ops.edge[:, 0].any()) and bool(ops.edge[:, 1].any())
    args = (TSB.kernel_disc_offsets(cfg.ilqr, cfg.vehicle),
            cfg.ilqr.barrier.t, cfg.ilqr.barrier.epsilon)
    got = TCS.corridor_lane_stack_ref(xs, ops, *args, want_derivs=True,
                                      want_sel=True)
    want = TCS.corridor_lane_stack_windowed(
        xs, (cbl.ca, cbl.cb, cbl.cc, cbl.cm), cbl.lanes, *args,
        want_derivs=True, want_sel=True)
    assert len(got) == 13
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    if problem == "fixture":
        assert bool(got[2].any())   # some selections clip at an edge


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stack_operands_with_one_full_scan_side(dtype):
    """A side of S <= W segments stays a full scan in ConsBL while the
    other is windowed; the kernel still takes the call: the full-scan side
    becomes the window at start 0 of its rows padded with masked segments,
    and the plain version on the operands equals, bit for bit, the
    windowed math with that side scanned whole at every knot (no clip)."""
    cfg, xs, cbl = _fixture_torch(dtype, 32, right_s=20)
    ops = cbl.stack
    N, B = xs.shape[1:]
    assert cbl.lanes[0][0].dim() == 3 and cbl.lanes[1][0].dim() == 2
    assert tuple(ops.segs.shape) == (2, 8, 40, B)
    assert not bool(ops.start[1].any()) and not bool(ops.edge[1].any())
    assert not bool(ops.segs[1, :, 20:].any())    # masked padding
    kcfg = dataclasses.replace(cfg.ilqr, cost_stack_backend="pallas")
    assert TSB._use_coststack_kernel(kcfg, cbl, xs)
    full = tuple(v[None].expand(N, *v.shape) for v in cbl.lanes[1][:8])
    no_clip = torch.zeros((N, B), dtype=torch.bool)
    args = (TSB.kernel_disc_offsets(cfg.ilqr, cfg.vehicle),
            cfg.ilqr.barrier.t, cfg.ilqr.barrier.epsilon)
    got = TCS.corridor_lane_stack_ref(xs, ops, *args, want_derivs=True,
                                      want_sel=True)
    want = TCS.corridor_lane_stack_windowed(
        xs, (cbl.ca, cbl.cb, cbl.cc, cbl.cm),
        (cbl.lanes[0], full + (no_clip, no_clip)), *args, want_derivs=True,
        want_sel=True)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


def _compare_stacks(rj, rt, tol):
    """(cost, pk, clip[, Jx, Ju, Hx, Hu]) of the two packages."""
    for name in ("total", "target", "dynamic", "corridor", "lane"):
        _close(getattr(rt[0], name), getattr(rj[0], name), tol)
    _close(rt[1], rj[1], tol)
    np.testing.assert_array_equal(rt[2].numpy(), np.asarray(rj[2]))
    for g, w in zip(rt[3:], rj[3:]):
        _close(g, w, tol)


@pytest.mark.parametrize("kind", ["relax", "exponential", "quadratic"])
@pytest.mark.parametrize("want_derivs", [False, True])
def test_cost_stack_matches_jax_synthetic(want_derivs, kind):
    cfg, xs, us, goals_bl, cbl = _synthetic(np.float64)
    ilqr = dataclasses.replace(
        cfg.ilqr, cost_stack_backend="xla", lane_window=4,
        barrier=dataclasses.replace(cfg.ilqr.barrier, kind=kind))
    rj = JSB._cost_stack_bl(xs, us, goals_bl, cbl, ilqr, cfg.vehicle,
                            want_derivs)
    rt = TSB._cost_stack_bl(
        torch.as_tensor(np.array(xs)), torch.as_tensor(np.array(us)),
        torch.as_tensor(np.array(goals_bl)), _torch_cbl(cbl), ilqr,
        cfg.vehicle, want_derivs)
    _compare_stacks(rj, rt, TOLS[np.float64])


def _fixture_problem(n):
    """First n fixture problems in float64: (torch goals_bl, torch cons,
    JAX goals_bl, JAX cons), goals transformed to start at the start
    state."""
    g, s, cons = load_fixture(dtype=torch.float64, device="cpu")
    g, s, cons = g[:n], s[:n], cons.map(lambda a: a[:n])
    from cilqr_tpu_torch.solver import transform_goals

    gt = TSB._bl(transform_goals(g, s))
    jcons = JConstraintSet(*(jnp.asarray(a.numpy()) for a in cons))
    return gt, cons, jnp.asarray(gt.numpy()), jcons


@pytest.mark.parametrize("lane_window", [32, 0])
def test_cons_to_bl_windows_identical(lane_window):
    gt, cons, gj, jcons = _fixture_problem(16)
    tb = TSB.cons_to_bl(cons, goals_bl=gt, lane_window=lane_window)
    jb = JSB.cons_to_bl(jcons, goals_bl=gj, lane_window=lane_window)
    for name in ("ca", "cb", "cc", "cm"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    for ts, js in zip(tb.lanes, jb.lanes):
        assert len(ts) == len(js) == 10
        for tv, jv in zip(ts, js):
            if jv is None:
                assert tv is None
            else:
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if lane_window:
        assert tb.lanes[0][0].shape == (81, lane_window, 16)


@pytest.mark.parametrize("want_derivs", [False, True])
def test_cost_stack_matches_jax_fixture(want_derivs):
    """Real corridors and W=32 lane windows, at the LQR initial guess."""
    from cilqr_tpu_torch.config import PlannerConfig
    from cilqr_tpu_torch.solver import iqr_init

    cfg = PlannerConfig()
    ilqr = dataclasses.replace(cfg.ilqr, cost_stack_backend="xla")
    gt, cons, gj, jcons = _fixture_problem(8)
    xs0, us0 = iqr_init(TSB._bf(gt), ilqr, cfg.vehicle, cfg.delta_t)
    xs, us = TSB._bl(xs0), TSB._bl(us0)
    tb = TSB.cons_to_bl(cons, goals_bl=gt, lane_window=ilqr.lane_window)
    jb = JSB.cons_to_bl(jcons, goals_bl=gj, lane_window=ilqr.lane_window)
    rt = TSB._cost_stack_bl(xs, us, gt, tb, ilqr, cfg.vehicle, want_derivs)
    rj = JSB._cost_stack_bl(jnp.asarray(xs.numpy()), jnp.asarray(us.numpy()),
                            gj, jb, ilqr, cfg.vehicle, want_derivs)
    _compare_stacks(rj, rt, TOLS[np.float64])
    # the kernel route on the CPU (the wrapper's plain version) agrees too
    rp = TSB._cost_stack_bl(
        xs, us, gt, tb, dataclasses.replace(ilqr, cost_stack_backend="pallas"),
        cfg.vehicle, want_derivs)
    _compare_stacks(rj, rp, TOLS[np.float64])


def test_constraints_cross_from_jax_and_trim_alike():
    d = np.load(FIXTURE)
    raw = [d[k][:4] for k in JConstraintSet._fields]
    jcons = jax_trim(JConstraintSet(*(jnp.asarray(a) for a in raw)))
    tcons = trim_constraints(constraints_from_numpy(raw, torch.float32,
                                                    "cpu"))
    back = constraints_from_numpy(jcons, torch.float32, "cpu")
    for a, b in zip(back, tcons):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
