"""cilqr_tpu_torch — the CILQR planner in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``cilqr_tpu`` (JAX on a TPU), which stays the reference it is
tested against. Modules keep the JAX package's names and layout:

  config                              — copy of cilqr_tpu/config.py
  types                               — Traj, Scenario, CorridorSet,
                                        SolverStatus, CostBreakdown, SolveResult
  geometry, model, barriers, costs    — per-knot math, constraint prep,
                                        total_cost, cost_derivatives
  scenario, reference_line, world     — scenarios, road queries, probes
                                        (BarrierGrid, every collision mode)
  dp, corridor                        — DP coarse search, safe corridors
  lqr, tracker                        — DARE fixed point, the tracker
                                        initial guess
  solver                              — the single-problem solver (batch
                                        first), goal transform, LQR guess
  pscan                               — the horizon-parallel backward pass
  solver_blast                        — the batch-last solve loop
  kernels.sweep, kernels.coststack,
  kernels.megasolve                   — CUDA kernels + plain PyTorch versions
  batch                               — solve_batch ("blast", "mega",
                                        "vmap") + metrics
  pipeline                            — plan_batch (the replan), plan
  mpc                                 — the receding-horizon MPC loop,
                                        batched and single
  dist                                — torch.distributed process
                                        groups, sharded solve, replan
                                        and MPC steps
  convert                             — crossing from the JAX package
  checkpoint                          — npz files in the JAX package's
                                        layout
  profiling                           — the tracer (spans, counters),
                                        timers, trace capture
  viz                                 — matplotlib figures (imported
                                        lazily)
  bench_prep, run                     — the fixture generator and the
                                        CLI (python -m ...; not imported
                                        here, so that -m runs them fresh)

Importing it never imports JAX, and never builds a kernel: the CUDA
library is compiled at first launch (kernels/_build.py).
"""

from . import (barriers, batch, checkpoint, config, convert, corridor,
               costs, dist, dp, geometry, lqr, model, mpc, pipeline,
               profiling, pscan, reference_line, scenario, solver,
               solver_blast, tracker, types, viz, world)
from .config import DEFAULT_CONFIG, PlannerConfig
from .kernels import coststack, megasolve, sweep
from .types import SolverStatus

__version__ = "0.1.0"
