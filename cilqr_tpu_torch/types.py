"""Solver result types (PyTorch counterpart of cilqr_tpu/types.py).

The JAX package registers these as flax pytrees; here they are plain
dataclasses of tensors. ``Traj``, ``Scenario`` and ``CorridorSet`` belong
to the full replan and are not ported yet.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class SolverStatus(enum.IntEnum):
    """Exit states of the solver (same codes as cilqr_tpu.types)."""

    RUNNING = 0
    SUCCESS_GNORM = 1          # gnorm < tol and lambda small
    SUCCESS_ABS_COST = 2       # dcost < abs_cost_tol
    SUCCESS_REL_COST = 3       # dcost/cost < rel_cost_tol
    FAIL_LAMBDA_MAX = 4        # regularization blew up (kUnsolved)
    MAX_ITER = 5


@dataclasses.dataclass
class CostBreakdown:
    """Cost components per evaluation (ilqr_optimizer.h:14-27)."""

    total: torch.Tensor
    target: torch.Tensor     # tracking + control quadratics (JCost)
    dynamic: torch.Tensor    # state/control limit barriers
    corridor: torch.Tensor
    lane: torch.Tensor

    def map(self, fn, *others: "CostBreakdown") -> "CostBreakdown":
        """Apply ``fn`` field-wise over this and ``others``."""
        return CostBreakdown(*(
            fn(getattr(self, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)))


@dataclasses.dataclass
class SolveResult:
    """Output of a batched CILQR solve (leading batch axis).

    xs [B, N, 6]; us [B, N-1, 2]; status: SolverStatus codes; iters: outer
    iterations executed; cost: final CostBreakdown; init_xs/init_us: the
    LQR initial guess; lane_clipped: the windowed lane search saw an argmin
    on a clipped window edge at some point of the solve."""

    xs: torch.Tensor
    us: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    cost: CostBreakdown
    lam: torch.Tensor
    init_xs: torch.Tensor
    init_us: torch.Tensor
    lane_clipped: torch.Tensor | None = None
