"""The slice end to end: the port's batch.solve_batch against
cilqr_tpu.batch.solve_batch(backend="blast") on the same inputs, float64 on
the CPU (where both take their plain paths: the Pallas kernels' interpret
mode and the CUDA kernels' plain versions are only taken on request).

Decisions (status, iterations) must match lane for lane on the synthetic
problems; on fixture problems, where some lanes are threshold-chaotic
(tests/test_f32_fixture_gate.py), on at least 14 of 16 (measured 16/16,
max |du| 1.8e-10 on those). The port solves with its compaction cascade,
the JAX reference in one phase (``_one_phase``): the cascade decides
every lane as one phase does (test_compaction_matches_single_phase holds
the port's), and JAX would compile its solve for each cascade width."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import costs as JC
from cilqr_tpu.batch import BatchMetrics as JBatchMetrics
from cilqr_tpu.batch import device_metrics as jax_device_metrics
from cilqr_tpu.batch import solve_batch as jax_solve_batch
from cilqr_tpu.config import IlqrConfig, PlannerConfig, VehicleParam
from cilqr_tpu.costs import ConstraintSet as JConstraintSet
from cilqr_tpu.costs import trim_constraints as jax_trim
from cilqr_tpu_torch import batch as TB
from cilqr_tpu_torch import solver_blast as TSB
from cilqr_tpu_torch.convert import (FIXTURE, config_from_dict,
                                     constraints_from_numpy, load_fixture,
                                     result_to_numpy)
from cilqr_tpu_torch.kernels import coststack as TCS
from cilqr_tpu_torch.kernels import sweep as TSW

from test_native_parity import _problem

torch.set_num_threads(1)

VEH = VehicleParam()
CFG = IlqrConfig()
DT = 0.1
N_FIX = 16


def _one_phase(ilqr):
    """The JAX reference's solver configuration: the same, in one phase."""
    return dataclasses.replace(ilqr, compaction_phase1=0)


def _synthetic_batch(seeds):
    """test_native_parity problems, shrunk and stacked by the JAX package."""
    gs, cs, ss = [], [], []
    for seed in seeds:
        goals, planes, mask, lp, ls, rp, rs, m, start = _problem(seed)
        cons = JC.shrink_and_normalize(
            jnp.asarray(planes), jnp.asarray(mask), jnp.asarray(lp),
            jnp.asarray(ls), jnp.asarray(m), jnp.asarray(rp),
            jnp.asarray(rs), jnp.asarray(m), CFG, VEH)
        gs.append(goals)
        cs.append(cons)
        ss.append(start)
    return (jnp.asarray(np.stack(gs)), jnp.asarray(np.stack(ss)),
            jax.tree.map(lambda *a: jnp.stack(a), *cs))


def _to_torch(goals, starts, cons):
    return (torch.as_tensor(np.array(goals)),
            torch.as_tensor(np.array(starts)),
            constraints_from_numpy(cons, torch.float64, "cpu"))


def test_solve_matches_jax_synthetic():
    goals, starts, cons = _synthetic_batch(range(6))
    rj = jax_solve_batch(goals, starts, cons, _one_phase(CFG), VEH, DT,
                         backend="blast")
    tcfg = config_from_dict(dataclasses.asdict(PlannerConfig()))
    rt = TB.solve_batch(*_to_torch(goals, starts, cons), tcfg.ilqr,
                        tcfg.vehicle, DT)
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), atol=1e-9)
    np.testing.assert_allclose(rt.xs.numpy(), np.asarray(rj.xs), atol=1e-8)
    np.testing.assert_allclose(rt.init_us.numpy(), np.asarray(rj.init_us),
                               atol=1e-10)
    np.testing.assert_allclose(rt.cost.total.numpy(),
                               np.asarray(rj.cost.total), rtol=1e-9)
    np.testing.assert_allclose(rt.lam.numpy(), np.asarray(rj.lam),
                               rtol=1e-12)
    np.testing.assert_array_equal(rt.lane_clipped.numpy(),
                                  np.asarray(rj.lane_clipped))

    # metrics agree with the JAX package's
    mt, mj = TB.BatchMetrics.from_result(rt), JBatchMetrics.from_result(rj)
    assert mt.n == mj.n and mt.status_counts == mj.status_counts
    assert mt.converged_fraction == mj.converged_fraction
    assert mt.iters_p99 == mj.iters_p99
    assert mt.lane_clipped_count == mj.lane_clipped_count
    np.testing.assert_allclose(mt.cost_total_mean, mj.cost_total_mean,
                               rtol=1e-9)
    dt_, dj = TB.device_metrics(rt), jax_device_metrics(rj)
    assert set(dt_) == set(dj)
    for k in dj:
        assert dt_[k].dtype == torch.float32
        np.testing.assert_allclose(float(dt_[k]), float(dj[k]), rtol=1e-6)
    out = result_to_numpy(rt)
    assert out["us"].shape == (6, 80, 2) and out["cost_total"].shape == (6,)


@pytest.fixture(scope="module")
def fixture_runs():
    """The first N_FIX fixture problems in float64, solved once by the JAX
    package; the port's inputs alongside."""
    d = np.load(FIXTURE)
    raw = {k: d[k][:N_FIX] for k in ("goals", "starts")
           + JConstraintSet._fields}

    def jx(a):
        return jnp.asarray(a, jnp.float64 if a.dtype != np.bool_ else None)

    jcons = jax_trim(JConstraintSet(*(jx(raw[k])
                                      for k in JConstraintSet._fields)))
    cfg = PlannerConfig()
    rj = jax_solve_batch(jx(raw["goals"]), jx(raw["starts"]), jcons,
                         _one_phase(cfg.ilqr), cfg.vehicle, cfg.delta_t,
                         backend="blast")
    g, s, c = load_fixture(dtype=torch.float64, device="cpu")
    return rj, (g[:N_FIX], s[:N_FIX], c.map(lambda a: a[:N_FIX]))


def _fixture_decisions(rt, rj):
    st_j, it_j = np.asarray(rj.status), np.asarray(rj.iters)
    assert np.isin(st_j, (1, 2, 3)).all()
    assert np.isin(rt.status.numpy(), (1, 2, 3)).all()
    same = (rt.status.numpy() == st_j) & (rt.iters.numpy() == it_j)
    assert same.sum() >= 14, int(same.sum())
    du = np.abs(rt.us.numpy() - np.asarray(rj.us)).max(axis=(1, 2))
    assert du[same].max() <= 1e-6, float(du[same].max())


def test_solve_matches_jax_fixture(fixture_runs):
    rj, (g, s, c) = fixture_runs
    cfg = PlannerConfig()
    rt = TB.solve_batch(g, s, c, cfg.ilqr, cfg.vehicle, cfg.delta_t)
    _fixture_decisions(rt, rj)


def test_solve_through_kernel_wrappers_on_cpu(fixture_runs):
    """sweep_backend / cost_stack_backend 'pallas' route the solve through
    the kernel wrappers, which take their plain versions on the CPU."""
    rj, (g, s, c) = fixture_runs
    cfg = PlannerConfig()
    ilqr = dataclasses.replace(cfg.ilqr, sweep_backend="pallas",
                               cost_stack_backend="pallas")
    before = (TSW.riccati_sweep.launches, TCS.corridor_lane_stack.launches)
    trips = TSB._run_carry.trips
    rt = TB.solve_batch(g, s, c, ilqr, cfg.vehicle, cfg.delta_t)
    assert (TSW.riccati_sweep.launches,
            TCS.corridor_lane_stack.launches) == before
    assert TSB._run_carry.trips > trips
    _fixture_decisions(rt, rj)


def test_compaction_matches_single_phase(fixture_runs):
    """Compaction rounds gather and scatter lanes without changing any
    lane's decisions (no batch-axis reduction in the loop body)."""
    _, (g, s, c) = fixture_runs
    cfg = PlannerConfig()
    r1 = TB.solve_batch(g[:8], s[:8], c.map(lambda a: a[:8]),
                        dataclasses.replace(cfg.ilqr, compaction_phase1=0),
                        cfg.vehicle, cfg.delta_t)
    r2 = TB.solve_batch(g[:8], s[:8], c.map(lambda a: a[:8]),
                        dataclasses.replace(cfg.ilqr, compaction_phase1=2,
                                            compaction_phase1_trips=3),
                        cfg.vehicle, cfg.delta_t)
    assert torch.equal(r1.status, r2.status)
    assert torch.equal(r1.iters, r2.iters)
    assert torch.equal(r1.lam, r2.lam)
    np.testing.assert_allclose(r2.us.numpy(), r1.us.numpy(), atol=1e-12)


@pytest.mark.parametrize("backend", ["vmap"])
def test_unported_backends_raise(backend):
    g, s, c = _to_torch(*_synthetic_batch(range(2)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TB.solve_batch(g, s, c, CFG, VEH, DT, backend=backend)


def test_load_fixture_tiles_and_trims():
    g, s, c = load_fixture(dtype=torch.float32, device="cpu", batch=300)
    assert g.shape == (300, 81, 6) and s.shape == (300, 6)
    assert torch.equal(g[256:], g[:44])
    assert c.corridor_planes.shape == (300, 81, 16, 3)
    assert c.left_planes.shape == (300, 40, 3)
    assert c.corridor_mask.dtype == torch.bool
