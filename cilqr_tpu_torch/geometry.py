"""Vectorized 2-D geometry primitives (PyTorch counterpart of
cilqr_tpu/geometry.py).

Every function works on tensors with any leading batch shape: the JAX
package writes them for one problem and vmaps, here the batch axes are
carried through. Each keeps the JAX function's operations in their order,
so that float64 results agree to round-off and decisions (comparisons,
sorts, argmins) agree exactly.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def normalize_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap angle to [-pi, pi). Matches math_utils.cpp:53-59.

    ``torch.remainder`` is the same floored modulo as ``jnp.mod``, so this
    equals the JAX function bit for bit."""
    return torch.remainder(x + math.pi, TWO_PI) - math.pi


def hypot(x1, x2):
    """sqrt(x1^2 + x2^2) by the JAX package's formula (jnp.hypot):
    max * sqrt(1 + (min/max)^2), not the C library's ``torch.hypot``. The
    replan's geometry takes this one, so that its decisions (hull
    membership, the corridors' dual hulls) see the values the JAX
    package's formula gives (to the rounding of its square root and of
    the sum, which XLA fuses into one multiply-add)."""
    x1, x2 = x1.abs(), x2.abs()
    inf = torch.isposinf(x1) | torch.isposinf(x2)
    hi, lo = torch.maximum(x1, x2), torch.minimum(x1, x2)
    r = lo / torch.where(hi == 0, torch.ones_like(hi), hi)
    x = torch.where(hi == 0, hi, hi * torch.sqrt(1 + r * r))
    return torch.where(inf, torch.full_like(x, math.inf), x)


def slerp(a0, t0, a1, t1, t):
    """Angle interpolation with wrap handling (math_utils.h:208-225)."""
    a0n = normalize_angle(a0)
    a1n = normalize_angle(a1)
    d = a1n - a0n
    d = torch.where(d > math.pi, d - TWO_PI, d)
    d = torch.where(d < -math.pi, d + TWO_PI, d)
    denom = t1 - t0
    r = torch.where(denom.abs() <= 1e-10, torch.zeros_like(denom),
                    (t - t0) / torch.where(denom == 0,
                                           torch.ones_like(denom), denom))
    return normalize_angle(a0n + d * r)


def lerp(x0, t0, x1, t1, t):
    denom = t1 - t0
    r = torch.where(denom.abs() <= 1e-6, torch.zeros_like(denom),
                    (t - t0) / torch.where(denom == 0,
                                           torch.ones_like(denom), denom))
    return x0 + r * (x1 - x0)


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


def rot(x, y, theta):
    c = torch.cos(theta)
    s = torch.sin(theta)
    return c * x - s * y, s * x + c * y


def box_corners(cx, cy, theta, length, width):
    """Corners of an oriented box, CCW. Returns [..., 4, 2]."""
    hl = length / 2.0
    hw = width / 2.0
    lx = torch.tensor([hl, -hl, -hl, hl], dtype=cx.dtype, device=cx.device)
    ly = torch.tensor([hw, hw, -hw, -hw], dtype=cx.dtype, device=cx.device)
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    px = cx[..., None] + c * lx - s * ly
    py = cy[..., None] + s * lx + c * ly
    return torch.stack([px, py], dim=-1)


def _first_valid_fill(poly, mask):
    """Replace invalid vertices with the first valid one so padded slots
    never extend projection intervals and padded edges are zero-length.
    poly [..., K, 2], mask broadcastable to [..., K]."""
    mask = torch.broadcast_to(mask, poly.shape[:-1])
    first_i = torch.argmax(mask.to(torch.int8), dim=-1)
    first = torch.gather(poly, -2, first_i[..., None, None].expand(
        *poly.shape[:-2], 1, 2))
    return torch.where(mask[..., None], poly, first), mask


def convex_overlap_aabb(poly, poly_mask, minx, miny, maxx, maxy):
    """SAT overlap of a convex polygon (padded [..., K, 2] + mask [..., K])
    with axis-aligned boxes (Polygon2d::HasOverlap(Box2d) for convex
    inputs, environment.cpp:46-112). Box bounds broadcast against the
    polygon's batch shape. An invalid polygon (mask all false) overlaps
    nothing."""
    pts, poly_mask = _first_valid_fill(poly, poly_mask)
    px = pts[..., 0]
    py = pts[..., 1]
    sep_x = (px.amax(dim=-1) < minx) | (px.amin(dim=-1) > maxx)
    sep_y = (py.amax(dim=-1) < miny) | (py.amin(dim=-1) > maxy)

    # polygon edge normals n = (ey, -ex); padded duplicates give
    # zero-length edges whose projections never separate
    nxt = torch.roll(pts, -1, dims=-2)
    ex = nxt[..., 0] - px
    ey = nxt[..., 1] - py
    cxs = torch.stack(torch.broadcast_tensors(minx, minx, maxx, maxx), -1)
    cys = torch.stack(torch.broadcast_tensors(miny, maxy, miny, maxy), -1)
    pn = px[..., None, :] * ey[..., :, None] + py[..., None, :] * (
        -ex[..., :, None])
    bn = cxs[..., None, :] * ey[..., :, None] + cys[..., None, :] * (
        -ex[..., :, None])
    # pn, bn: [..., K(normal), K(vertex)] / [..., K(normal), 4]
    deg = (ex.abs() + ey.abs()) <= 0
    sep_edge = (((pn.amax(dim=-1) < bn.amin(dim=-1))
                 | (pn.amin(dim=-1) > bn.amax(dim=-1))) & ~deg)
    any_valid = poly_mask.any(dim=-1)
    return any_valid & ~(sep_x | sep_y | sep_edge.any(dim=-1))


def _sat_separates(pts_a, pts_b):
    """True if any edge normal of convex polygon A separates A from B.
    pts_a/pts_b: [..., Ka, 2] / [..., Kb, 2] (padded slots pre-filled)."""
    nxt = torch.roll(pts_a, -1, dims=-2)
    ex = nxt[..., 0] - pts_a[..., 0]
    ey = nxt[..., 1] - pts_a[..., 1]
    deg = (ex.abs() + ey.abs()) <= 0
    pa = (pts_a[..., None, :, 0] * ey[..., :, None]
          - pts_a[..., None, :, 1] * ex[..., :, None])
    pb = (pts_b[..., None, :, 0] * ey[..., :, None]
          - pts_b[..., None, :, 1] * ex[..., :, None])
    sep = (((pa.amax(-1) < pb.amin(-1)) | (pa.amin(-1) > pb.amax(-1)))
           & ~deg)
    return sep.any(dim=-1)


def convex_overlap(poly_a, mask_a, poly_b, mask_b):
    """General SAT overlap of two convex polygons (padded [..., Ka, 2] /
    [..., Kb, 2] + masks; Box2d / Polygon2d::HasOverlap for convex
    inputs). Either polygon fully invalid -> no overlap."""
    pa, ma = _first_valid_fill(poly_a, mask_a)
    pb, mb = _first_valid_fill(poly_b, mask_b)
    sep = _sat_separates(pa, pb) | _sat_separates(pb, pa)
    return ma.any(dim=-1) & mb.any(dim=-1) & ~sep


def point_in_convex_polygon(px, py, poly, mask, eps: float = 0.0):
    """Closed point-membership test for a convex polygon with vertices in a
    consistent winding order, padded + masked (Polygon2d::IsPointIn for
    convex inputs)."""
    pts, m = _first_valid_fill(poly, mask)
    nxt = torch.roll(pts, -1, dims=-2)
    cr = ((nxt[..., 0] - pts[..., 0]) * (py[..., None] - pts[..., 1])
          - (nxt[..., 1] - pts[..., 1]) * (px[..., None] - pts[..., 0]))
    deg = ((nxt[..., 0] - pts[..., 0]).abs()
           + (nxt[..., 1] - pts[..., 1]).abs()) <= 0
    pos = (cr >= -eps) | deg
    neg = (cr <= eps) | deg
    return m.any(dim=-1) & (pos.all(dim=-1) | neg.all(dim=-1))


def sample_polygon_edges(corners, multiple: int = 5):
    """Boundary samples of a polygon at ratio steps 1/multiple per edge,
    endpoints inclusive (Polygon2d::sample_points, polygon2d.cpp:259-271:
    corners appear twice). corners [..., K, 2] -> [..., K*(multiple+1), 2]."""
    nxt = torch.roll(corners, -1, dims=-2)
    r = torch.arange(multiple + 1, dtype=corners.dtype,
                     device=corners.device) / multiple
    pts = (corners[..., :, None, :] * (1 - r)[:, None]
           + nxt[..., :, None, :] * r[:, None])
    return pts.reshape(corners.shape[:-2] + (-1, 2))


# ---------------------------------------------------------------------------
# Masked convex hull (monotone-chain semantics, chord-slope formulation)
# ---------------------------------------------------------------------------

def _chain_membership(sx, sy, valid):
    """Lower/upper monotone-chain membership over lexicographically sorted
    points [..., K] by pairwise chord slopes (O(K^2), no stack walk).

    Point k is BELOW every chord spanning it iff max_{i<k} slope(i,k) <
    min_{j>k} slope(k,j) (lower-hull vertex), ABOVE every chord iff
    min_{i<k} slope(i,k) > max_{j>k} slope(k,j) (upper-hull vertex); strict
    inequalities drop collinear boundary points. Requires deduplicated
    inputs; invalid pairs (0/0 slopes) are masked before the reductions."""
    K = sx.shape[-1]
    q = torch.arange(K, device=sx.device)
    dx = sx[..., None, :] - sx[..., :, None]          # [..., i, k]
    dy = sy[..., None, :] - sy[..., :, None]
    pair = ((q[:, None] < q[None, :]) & valid[..., :, None]
            & valid[..., None, :])
    slope = dy / dx                                    # +inf for vertical
    inf = torch.tensor(math.inf, dtype=sx.dtype, device=sx.device)
    lo_fill = torch.where(pair, slope, -inf)
    hi_fill = torch.where(pair, slope, inf)
    max_l = lo_fill.amax(dim=-2)                       # [..., k]
    min_l = hi_fill.amin(dim=-2)
    max_r = lo_fill.amax(dim=-1)                       # [..., i]
    min_r = hi_fill.amin(dim=-1)
    lower = (max_l < min_r) & valid
    upper = (min_l > max_r) & valid
    return lower, upper


def convex_hull_masked(pts, mask, return_indices: bool = False,
                       payload: tuple = ()):
    """Convex hull of padded point sets pts [..., K, 2], mask [..., K].

    Returns (hull_pts [..., K, 2], hull_mask [..., K], count [...]), plus
    hull indices into ``pts`` when ``return_indices``, plus a tuple of
    per-hull-vertex ``payload`` values when payload tensors ([..., K]) are
    given; hull vertices counter-clockwise from the lexicographically
    smallest point, collinear boundary points dropped (cv::convexHull's
    extreme vertices, corridor.cc:184,218).

    The orderings are stable sorts, as the JAX package's variadic
    ``lax.sort``: lexicographic (x, y) as two stable passes (y first; -0.0
    and +0.0 compare equal, as there), invalid points last in index order;
    then the output rank (lower chain ascending minus its rightmost point,
    then upper chain descending minus its leftmost)."""
    K = pts.shape[-2]
    dev = pts.device
    big = torch.tensor(1e30, dtype=pts.dtype, device=dev)
    px = pts[..., 0]
    py = pts[..., 1]
    idx = torch.arange(K, device=dev)
    # exact duplicates (later occurrence invalidated): the slope test needs
    # them gone (0/0 slopes)
    same = ((px[..., None, :] == px[..., :, None])
            & (py[..., None, :] == py[..., :, None]))
    dup = (same & mask[..., :, None]
           & (idx[:, None] < idx[None, :])).any(dim=-2)
    mask = mask & ~dup
    x = torch.where(mask, px, big)
    y = torch.where(mask, py, big)
    # lexicographic (x, y), stable: secondary key first
    o1 = torch.sort(y, dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(x, -1, o1), dim=-1, stable=True).indices
    order = torch.gather(o1, -1, o2)
    sx = torch.gather(x, -1, order)
    sy = torch.gather(y, -1, order)
    spay = [torch.gather(p, -1, order) for p in payload]
    m = mask.sum(dim=-1, keepdim=True)
    q = idx
    valid = q < m

    lower, upper = _chain_membership(sx, sy, valid)

    bigi = 4 * K
    lower_rank = torch.where(
        lower & ((q < m - 1) | ((m == 1) & (q == 0))), q,
        torch.full_like(q, bigi))
    upper_rank = torch.where(upper & (q > 0), 2 * K - q,
                             torch.full_like(q, bigi))
    rank = torch.minimum(lower_rank, upper_rank)
    count = (rank < bigi).sum(dim=-1)
    hmask = idx < count[..., None]
    o3 = torch.sort(rank, dim=-1, stable=True).indices
    zero = torch.zeros((), dtype=pts.dtype, device=dev)
    hx = torch.where(hmask, torch.gather(sx, -1, o3), zero)
    hy = torch.where(hmask, torch.gather(sy, -1, o3), zero)
    out = (torch.stack([hx, hy], dim=-1), hmask, count)
    if return_indices:
        oidx = torch.gather(order, -1, o3)
        out = out + (torch.where(hmask, oidx, torch.zeros_like(oidx)),)
    if payload:
        out = out + (tuple(
            torch.where(hmask, torch.gather(p, -1, o3), torch.zeros_like(p))
            for p in spay),)
    return out
