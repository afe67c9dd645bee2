"""CILQR constraint preparation and cost evaluation (PyTorch counterpart
of cilqr_tpu/costs.py).

``total_cost`` evaluates TotalCost with its breakdown over a batch of
trajectories (the replan re-costs its repaired lanes with it). The
per-problem ``cost_derivatives`` is not ported; the batched solve
evaluates its cost stack and derivatives in solver_blast.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .barriers import make_barrier
from .config import IlqrConfig, VehicleParam
from .geometry import point_segment_distance
from .types import CostBreakdown


class ConstraintSet(NamedTuple):
    """Shrunk + normalized constraints fed to the solver.

    corridor_planes: [..., N, KC, 3]; corridor_mask: [..., N, KC] (bool)
    left/right lane planes [..., S, 3], segs [..., S, 2, 2], mask [..., S]
    """

    corridor_planes: torch.Tensor
    corridor_mask: torch.Tensor
    left_planes: torch.Tensor
    left_segs: torch.Tensor
    left_mask: torch.Tensor
    right_planes: torch.Tensor
    right_segs: torch.Tensor
    right_mask: torch.Tensor

    def map(self, fn) -> "ConstraintSet":
        return ConstraintSet(*(fn(v) for v in self))


def _shift(planes, r):
    """c -= r * hypot(a, b): moves the boundary r metres inward."""
    ab = torch.hypot(planes[..., 0], planes[..., 1])
    return torch.cat([planes[..., :2], (planes[..., 2] - r * ab)[..., None]],
                     dim=-1)


def shrink_and_normalize(planes_corridor, corridor_mask,
                         left_planes, left_segs, left_mask,
                         right_planes, right_segs, right_mask,
                         cfg: IlqrConfig, veh: VehicleParam) -> ConstraintSet:
    """ShrinkConstraints + NormalizeHalfPlane (ilqr_optimizer.cc:438-495),
    plus cfg.cover_margin on both shrink radii (see cilqr_tpu.costs).
    Normalize divides (a, b, c) by the reference's 3-vector norm."""
    r_corr = (veh.disc_radius(cfg.num_of_disc) + cfg.safe_margin
              + cfg.cover_margin)
    r_lane = veh.disc_radius(cfg.num_of_disc) + cfg.cover_margin

    def normalize(planes):
        n = torch.sqrt(planes[..., 0] ** 2 + planes[..., 1] ** 2
                       + planes[..., 2] ** 2)
        n = torch.where(n > 0, n, torch.ones_like(n))
        return planes / n[..., None]

    return ConstraintSet(
        corridor_planes=normalize(_shift(planes_corridor, r_corr)),
        corridor_mask=corridor_mask,
        left_planes=normalize(_shift(left_planes, r_lane)),
        left_segs=left_segs,
        left_mask=left_mask,
        right_planes=normalize(_shift(right_planes, r_lane)),
        right_segs=right_segs,
        right_mask=right_mask,
    )


def tighten_constraints(cons: ConstraintSet, margin) -> ConstraintSet:
    """Shift every corridor and lane half-plane boundary inward by
    ``margin`` metres (c -= margin * hypot(a, b))."""
    return cons._replace(corridor_planes=_shift(cons.corridor_planes, margin),
                         left_planes=_shift(cons.left_planes, margin),
                         right_planes=_shift(cons.right_planes, margin))


def trim_constraints(cons: ConstraintSet, multiple: int = 8) -> ConstraintSet:
    """Trim padded constraint slots no problem uses (host-side): slice to
    the highest valid slot, rounded up to ``multiple``. Exact for any mask
    pattern, since everything dropped is masked out."""

    def hi(mask):
        used = mask.reshape(-1, mask.shape[-1]).any(dim=0)
        idx = torch.nonzero(used).flatten()
        n = int(idx[-1]) + 1 if idx.numel() else 1
        return min(mask.shape[-1], -(-n // multiple) * multiple)

    kc = hi(cons.corridor_mask)
    s = max(hi(cons.left_mask), hi(cons.right_mask))
    return ConstraintSet(
        corridor_planes=cons.corridor_planes[..., :kc, :],
        corridor_mask=cons.corridor_mask[..., :kc],
        left_planes=cons.left_planes[..., :s, :],
        left_segs=cons.left_segs[..., :s, :, :],
        left_mask=cons.left_mask[..., :s],
        right_planes=cons.right_planes[..., :s, :],
        right_segs=cons.right_segs[..., :s, :, :],
        right_mask=cons.right_mask[..., :s],
    )


def disc_geometry(xs, cfg: IlqrConfig, veh: VehicleParam):
    """Disc-centre offsets along the heading (ilqr_optimizer.cc:556-565):
    xs [..., N, 6] -> (cx, cy, length_cos, length_sin), each [..., N, D]."""
    D = cfg.num_of_disc
    L = veh.length / D
    rf = veh.rear_hang_length
    offs = L * (torch.arange(D, dtype=xs.dtype, device=xs.device) - 0.5) - rf
    ct = torch.cos(xs[..., 2])[..., None]
    st = torch.sin(xs[..., 2])[..., None]
    length_cos = offs * ct
    length_sin = offs * st
    cx = xs[..., 0:1] + length_cos
    cy = xs[..., 1:2] + length_sin
    return cx, cy, length_cos, length_sin


def _limit_terms_state(xs, veh: VehicleParam):
    """State-limit constraint values g <= 0, [..., N, 6], in DynamicsCost's
    order (ilqr_optimizer.cc:522-536): -v, v-vmax, a-amax, amin-a,
    delta-dmax, dmin-delta."""
    v = xs[..., 3]
    a = xs[..., 4]
    d = xs[..., 5]
    return torch.stack([-v, v - veh.max_velocity, a - veh.max_acceleration,
                        veh.min_acceleration - a, d - veh.delta_max,
                        veh.delta_min - d], dim=-1)


def _limit_terms_control(us, veh: VehicleParam):
    """Control-limit constraint values (ilqr_optimizer.cc:542-547),
    [..., T, 4]: jerk-jmax, jmin-jerk, drate-drmax, drmin-drate."""
    j = us[..., 0]
    dr = us[..., 1]
    return torch.stack([j - veh.jerk_max, veh.jerk_min - j,
                        dr - veh.delta_rate_max, veh.delta_rate_min - dr],
                       dim=-1)


def _nearest_lane_plane(cx, cy, planes, segs, mask):
    """FindNeastLaneSegment (ilqr_optimizer.cc:605-618): cx, cy [B, N, D];
    planes [B, S, 3], segs [B, S, 2, 2], mask [B, S]. The nearest valid
    segment's plane (first index on ties), [B, N, D, 3]."""
    sg = segs[:, None, None]                            # [B, 1, 1, S, 2, 2]
    d = point_segment_distance(cx[..., None], cy[..., None],
                               sg[..., 0, 0], sg[..., 0, 1],
                               sg[..., 1, 0], sg[..., 1, 1])
    d = torch.where(mask[:, None, None], d, torch.full_like(d, float("inf")))
    idx = torch.argmin(d, dim=-1)                       # [B, N, D]
    B = planes.shape[0]
    return torch.gather(planes, 1, idx.reshape(B, -1, 1).expand(-1, -1, 3)
                        ).reshape(idx.shape + (3,))


def total_cost(xs, us, goals, cons: ConstraintSet, cfg: IlqrConfig,
               veh: VehicleParam) -> CostBreakdown:
    """TotalCost (ilqr_optimizer.cc:417-436) with its breakdown, for a
    batch: xs [B, N, 6], us [B, T, 2], goals [B, N, 6], cons leaves
    [B, ...] -> CostBreakdown of [B] tensors. Each sum runs over the
    problem's own axes in the JAX function's order of terms."""
    bar = make_barrier(cfg.barrier)
    w = cfg.weights
    red = (-2, -1)

    # JCost (ilqr_optimizer.cc:497-516)
    dx = xs[..., 0] - goals[..., 0]
    dy = xs[..., 1] - goals[..., 1]
    dth = xs[..., 2] - goals[..., 2]
    j_cost = (w.x_target * dx * dx + w.y_target * dy * dy
              + w.theta * dth * dth).sum(-1)
    j_cost = j_cost + (w.jerk * us[..., 0] ** 2
                       + w.delta_rate * us[..., 1] ** 2).sum(-1)

    # limit barriers (DynamicsCost, ilqr_optimizer.cc:518-551)
    dyn_cost = (bar.value(_limit_terms_state(xs, veh)).sum(red)
                + bar.value(_limit_terms_control(us, veh)).sum(red))

    # corridor barriers (CorridorCost, ilqr_optimizer.cc:553-581)
    cx, cy, _, _ = disc_geometry(xs, cfg, veh)
    p = cons.corridor_planes                             # [B, N, KC, 3]
    g = (p[..., None, :, 0] * cx[..., None] + p[..., None, :, 1]
         * cy[..., None] - p[..., None, :, 2])           # [B, N, D, KC]
    corr_cost = torch.where(cons.corridor_mask[..., None, :], bar.value(g),
                            torch.zeros_like(g)).sum((-3, -2, -1))

    # lane barriers (LaneBoundaryCost, ilqr_optimizer.cc:583-603)
    lane_cost = torch.zeros_like(j_cost)
    for planes, segs, mask in ((cons.left_planes, cons.left_segs,
                                cons.left_mask),
                               (cons.right_planes, cons.right_segs,
                                cons.right_mask)):
        pl = _nearest_lane_plane(cx, cy, planes, segs, mask)  # [B, N, D, 3]
        gl = pl[..., 0] * cx + pl[..., 1] * cy - pl[..., 2]
        lane_cost = lane_cost + bar.value(gl).sum(red)

    total = j_cost + dyn_cost + corr_cost + lane_cost
    return CostBreakdown(total=total, target=j_cost, dynamic=dyn_cost,
                         corridor=corr_cost, lane=lane_cost)
