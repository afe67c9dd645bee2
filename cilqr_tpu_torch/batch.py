"""Batched solving + structured metrics (PyTorch counterpart of
cilqr_tpu/batch.py): ``solve_batch`` over its three backends ("blast",
"mega" and "vmap"), ``solve_batch_jit`` and the per-batch metrics."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .costs import ConstraintSet
from .profiling import spanned
from .types import SolveResult, SolverStatus


@spanned("solve")
def solve_batch(goals, starts, cons: ConstraintSet, cfg, veh, dt,
                warm_start=None, backend: str = "blast") -> SolveResult:
    """Batched CILQR solve over a leading batch axis on every input.

    backend='blast': the batch-last solver (solver_blast.solve_batch_bl),
    which runs the CUDA kernels for tensors on a card. backend='mega': the
    full-solve megakernel (kernels/megasolve.py), one launch per solve on a
    card. backend='vmap': the single-problem solver (solver.solve) over the
    batch, the JAX package's ``jax.vmap(solver.solve)`` and the semantic
    reference of the other two (identical decisions, controls to
    fp-reassociation noise); plain PyTorch, no kernel."""
    if backend == "blast":
        from .solver_blast import solve_batch_bl

        return solve_batch_bl(goals, starts, cons, cfg, veh, dt,
                              warm_start=warm_start)
    if backend == "mega":
        from .kernels.megasolve import solve_batch_mega

        return solve_batch_mega(goals, starts, cons, cfg, veh, dt,
                                warm_start=warm_start)
    if backend == "vmap":
        from .solver import solve

        return solve(goals, starts, cons, cfg, veh, dt,
                     warm_start=warm_start)
    raise ValueError(f"unknown backend {backend!r}")


def solve_batch_jit(cfg, backend: str = "blast"):
    """The batched solve as a closure over a static PlannerConfig (the JAX
    package's jitted closure; nothing is traced here)."""
    ilqr, veh, dt = cfg.ilqr, cfg.vehicle, cfg.delta_t

    def _f(goals, starts, cons):
        return solve_batch(goals, starts, cons, ilqr, veh, dt,
                           backend=backend)

    return _f


class BatchMetrics(NamedTuple):
    """Structured per-batch metrics (replaces the reference's stdout
    prints, ilqr_optimizer.cc:174-313)."""

    n: int
    converged_fraction: float
    status_counts: dict
    iters_mean: float
    iters_p50: float
    iters_p99: float
    cost_total_mean: float
    cost_components_mean: dict
    # lanes whose windowed lane-segment search may have selected a wrong
    # plane (SolveResult.lane_clipped); investigate any nonzero count
    lane_clipped_count: int = 0

    @staticmethod
    def from_result(res: SolveResult) -> "BatchMetrics":
        def host(t):
            return t.detach().cpu().numpy()

        status = host(res.status)
        iters = host(res.iters)
        succ = np.isin(status, (int(SolverStatus.SUCCESS_GNORM),
                                int(SolverStatus.SUCCESS_ABS_COST),
                                int(SolverStatus.SUCCESS_REL_COST)))
        counts = {SolverStatus(k).name: int((status == k).sum())
                  for k in np.unique(status)}
        return BatchMetrics(
            n=len(status),
            converged_fraction=float(succ.mean()),
            status_counts=counts,
            iters_mean=float(iters.mean()),
            iters_p50=float(np.percentile(iters, 50)),
            iters_p99=float(np.percentile(iters, 99)),
            cost_total_mean=float(host(res.cost.total).mean()),
            lane_clipped_count=(
                0 if res.lane_clipped is None
                else int(host(res.lane_clipped).sum())),
            cost_components_mean={
                "target": float(host(res.cost.target).mean()),
                "dynamic": float(host(res.cost.dynamic).mean()),
                "corridor": float(host(res.cost.corridor).mean()),
                "lane": float(host(res.cost.lane).mean()),
            })


def device_metrics(res: SolveResult):
    """Metric reduction on the result's device: a dict of float32 scalar
    tensors (sums, so that shards can be all-reduced)."""
    status = res.status
    succ = ((status == SolverStatus.SUCCESS_GNORM)
            | (status == SolverStatus.SUCCESS_ABS_COST)
            | (status == SolverStatus.SUCCESS_REL_COST))
    f32 = torch.float32
    return {
        "n": torch.tensor(float(status.shape[0]), dtype=f32,
                          device=status.device),
        "converged": succ.sum().to(f32),
        "iters_sum": res.iters.sum().to(f32),
        "cost_sum": res.cost.total.sum().to(f32),
    }
