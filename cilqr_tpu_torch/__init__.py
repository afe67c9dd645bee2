"""cilqr_tpu_torch — the CILQR planner's batched solve in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``cilqr_tpu`` (JAX on a TPU), which stays the reference it is
tested against. Modules keep the JAX package's names and layout:

  config                              — copy of cilqr_tpu/config.py
  types                               — SolverStatus, CostBreakdown, SolveResult
  geometry, model, barriers, costs    — per-knot math and constraint prep
  solver                              — goal transform and the LQR init guess
  solver_blast                        — the batch-last solve loop
  kernels.sweep, kernels.coststack,
  kernels.megasolve                   — CUDA kernels + plain PyTorch versions
  batch                               — solve_batch + metrics
  convert                             — crossing from the JAX package

Importing it never imports JAX, and never builds a kernel: the CUDA
library is compiled at first launch (kernels/_build.py).
"""

from . import (barriers, batch, config, convert, costs, geometry, model,
               solver, solver_blast, types)
from .config import DEFAULT_CONFIG, PlannerConfig
from .kernels import coststack, megasolve, sweep
from .types import SolverStatus

__version__ = "0.1.0"
