"""Constraint preparation for the CILQR cost stack (PyTorch counterpart
of the constraint half of cilqr_tpu/costs.py). The single-problem
``total_cost`` / ``cost_derivatives`` are not ported yet; the batched
solve evaluates its cost stack in solver_blast."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import IlqrConfig, VehicleParam


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
