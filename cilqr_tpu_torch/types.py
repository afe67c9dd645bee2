"""Data types of the planner (PyTorch counterpart of cilqr_tpu/types.py).

The JAX package registers these as flax pytrees and vmaps over them; here
they are plain dataclasses of tensors that carry the batch axis themselves
(a leading [B] on every field, or none for a single problem). ``map``
applies a function field by field, as ``jax.tree.map`` does.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class _Fields:
    """Field-wise helpers shared by the dataclasses below."""

    def map(self, fn, *others):
        """Apply ``fn`` field-wise over this and ``others`` (nested
        dataclasses are walked; None fields stay None)."""

        def one(v, *o):
            if v is None:
                return None
            if isinstance(v, _Fields):
                return v.map(fn, *o)
            return fn(v, *o)

        return type(self)(*(
            one(getattr(self, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)))


class SolverStatus(enum.IntEnum):
    """Exit states of the solver (same codes as cilqr_tpu.types)."""

    RUNNING = 0
    SUCCESS_GNORM = 1          # gnorm < tol and lambda small
    SUCCESS_ABS_COST = 2       # dcost < abs_cost_tol
    SUCCESS_REL_COST = 3       # dcost/cost < rel_cost_tol
    FAIL_LAMBDA_MAX = 4        # regularization blew up (kUnsolved)
    MAX_ITER = 5


@dataclasses.dataclass
class Traj(_Fields):
    """Struct-of-arrays trajectory / reference line: TrajectoryPoint's
    fields (discretized_trajectory.h) as [..., P] tensors. Also the
    centerline (with bounds) and the coarse DP output."""

    time: torch.Tensor
    s: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    theta: torch.Tensor
    kappa: torch.Tensor
    velocity: torch.Tensor
    left_bound: torch.Tensor
    right_bound: torch.Tensor
    a: torch.Tensor
    jerk: torch.Tensor
    delta: torch.Tensor
    delta_rate: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[-1]


@dataclasses.dataclass
class Scenario(_Fields):
    """World state tensors (Environment, environment.h:24-88), each with
    the batch axis leading when batched:

    static_obs [KS, 4, 2] corners, static_mask [KS]; dyn_obs [KD, TD, 4, 2]
    per-sample corners, dyn_times [KD, TD], dyn_mask [KD], dyn_len [KD];
    barrier_xy [NB, 2] road-barrier points of both bounds sorted by x,
    barrier_mask [NB]; left/right_barrier_xy [NB2, 2] per-side polylines in
    station order, with masks."""

    centerline: Traj
    static_obs: torch.Tensor
    static_mask: torch.Tensor
    dyn_obs: torch.Tensor
    dyn_times: torch.Tensor
    dyn_mask: torch.Tensor
    dyn_len: torch.Tensor
    barrier_xy: torch.Tensor
    barrier_mask: torch.Tensor
    left_barrier_xy: torch.Tensor
    left_barrier_mask: torch.Tensor
    right_barrier_xy: torch.Tensor
    right_barrier_mask: torch.Tensor


@dataclasses.dataclass
class CorridorSet(_Fields):
    """Per-knot convex safe corridors and the shared lane constraints:
    planes [..., N, KC, 3] (a x + b y <= c), plane_mask [..., N, KC],
    polygons [..., N, KC, 2], poly_mask [..., N, KC]; left/right_planes
    [..., S, 3], left/right_segs [..., S, 2, 2], left/right_mask [..., S];
    ok [..., N] per-knot construction success."""

    planes: torch.Tensor
    plane_mask: torch.Tensor
    polygons: torch.Tensor
    poly_mask: torch.Tensor
    left_planes: torch.Tensor
    left_segs: torch.Tensor
    left_mask: torch.Tensor
    right_planes: torch.Tensor
    right_segs: torch.Tensor
    right_mask: torch.Tensor
    ok: torch.Tensor


@dataclasses.dataclass
class CostBreakdown(_Fields):
    """Cost components per evaluation (ilqr_optimizer.h:14-27)."""

    total: torch.Tensor
    target: torch.Tensor     # tracking + control quadratics (JCost)
    dynamic: torch.Tensor    # state/control limit barriers
    corridor: torch.Tensor
    lane: torch.Tensor


@dataclasses.dataclass
class SolveResult(_Fields):
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
