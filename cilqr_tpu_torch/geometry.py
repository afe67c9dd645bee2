"""2-D geometry primitives of the solve (PyTorch counterpart of
cilqr_tpu/geometry.py; the rest of that module belongs to the replan)."""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def normalize_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap angle to [-pi, pi). Matches math_utils.cpp:53-59.

    ``torch.remainder`` is the same floored modulo as ``jnp.mod``, so this
    equals the JAX function bit for bit."""
    return torch.remainder(x + math.pi, TWO_PI) - math.pi


def point_segment_distance(px, py, ax, ay, bx, by):
    """Distance from point P to segment AB (line_segment2d.cpp semantics)."""
    abx = bx - ax
    aby = by - ay
    apx = px - ax
    apy = py - ay
    ab2 = abx * abx + aby * aby
    t = torch.where(ab2 > 0, (apx * abx + apy * aby)
                    / torch.where(ab2 == 0, torch.ones_like(ab2), ab2),
                    torch.zeros_like(ab2))
    t = torch.clamp(t, 0.0, 1.0)
    cx = ax + t * abx
    cy = ay + t * aby
    return torch.hypot(px - cx, py - cy)
