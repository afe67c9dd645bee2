"""Convex safe-corridor construction (PyTorch counterpart of
cilqr_tpu/corridor.py): sphere flip + double convex hull, batched over
scenarios and knots.

Per knot (BuildCorridor, corridor.cc:122-263): seeds -> filter (|dx|,
|dy| <= 25, norm > 0) -> flip p' = p(2R/|p| - 1) -> hull 1 of {flipped
points, origin} -> hull vertices mapped back to original coordinates
(origin-vertex interior-point fix) -> hull 2 -> per-seed half-planes with
hull-2 edge normals -> dual points -> dual hull -> polygon vertices ->
final half-planes a x + b y <= c. Deviations from the reference are the
JAX package's (see there): the safe radius of the LAST point below R, a
positive modulo for the origin's predecessor, extreme hull vertices only.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CorridorConfig
from .geometry import convex_hull_masked, hypot, sample_polygon_edges
from .profiling import span, spanned, upload
from .types import CorridorSet, Scenario, Traj
from .world import query_dynamic_points_grid

# (knot, seed, seed) pairs of the hulls' pairwise tests held at once:
# scenarios are processed in chunks of this many pairs
PAIRS_PER_CHUNK = 1 << 26


def _box_sample_points(x, y, theta, cfg: CorridorConfig):
    """AddCorridorPoints (corridor.cc:89-120): the 4 corners of a
    +-max_axis box around each pose [...], each edge sampled at ratios
    {0, 1} (8 points, corners twice), or at step 1/5 when
    is_multiple_sample (24 points). -> [..., 8 or 24, 2]."""
    ch = torch.cos(theta)
    sh = torch.sin(theta)
    dx1 = ch * cfg.max_axis_x
    dy1 = sh * cfg.max_axis_x
    dx2 = sh * cfg.max_axis_y
    dy2 = -ch * cfg.max_axis_y
    cx = torch.stack([x + dx1 + dx2, x + dx1 - dx2, x - dx1 - dx2,
                      x - dx1 + dx2], dim=-1)
    cy = torch.stack([y + dy1 + dy2, y + dy1 - dy2, y - dy1 - dy2,
                      y - dy1 + dy2], dim=-1)
    cur = torch.stack([cx, cy], dim=-1)
    return sample_polygon_edges(cur, 5 if cfg.is_multiple_sample else 1)


def corridor_seed_points(scn: Scenario, x, y, theta, cfg: CorridorConfig,
                         max_points: int, dyn):
    """Seed sets per knot (BuildCorridorConstraints, corridor.cc:56-87):
    static corners + dynamic corners at the knot's time + box samples,
    padded to max_points. Poses [B, N]; ``dyn`` = (points [B, N, KD*4, 2],
    mask [B, N, KD*4]) from world.query_dynamic_points_grid. With
    is_multiple_sample, obstacle boundaries are sampled 5x
    (environment.cpp:160-161,177-178). -> (pts [B, N, K, 2], mask)."""
    B, N = x.shape
    dyn_pts, dyn_mask = dyn
    if cfg.is_multiple_sample:
        st_pts = sample_polygon_edges(scn.static_obs, 5).reshape(B, -1, 2)
        st_mask = scn.static_mask.repeat_interleave(24, dim=-1)
        dyn_pts = sample_polygon_edges(
            dyn_pts.reshape(B, N, -1, 4, 2), 5).reshape(B, N, -1, 2)
        dyn_mask = dyn_mask.reshape(B, N, -1, 4)[..., 0].repeat_interleave(
            24, dim=-1)
    else:
        st_pts = scn.static_obs.reshape(B, -1, 2)
        st_mask = scn.static_mask.repeat_interleave(4, dim=-1)
    box_pts = _box_sample_points(x, y, theta, cfg)
    nb = box_pts.shape[-2]
    pts = torch.cat([st_pts[:, None].expand(B, N, -1, 2), dyn_pts, box_pts],
                    dim=-2)
    mask = torch.cat([st_mask[:, None].expand(B, N, -1), dyn_mask,
                      torch.ones((B, N, nb), dtype=torch.bool,
                                 device=x.device)], dim=-1)
    K = pts.shape[-2]
    if K > max_points:
        raise ValueError(f"corridor max_points={max_points} < seeds {K}")
    pad = max_points - K
    pts = torch.cat([pts, pts.new_zeros((B, N, pad, 2))], dim=-2)
    mask = torch.cat([mask, mask.new_zeros((B, N, pad))], dim=-1)
    return pts, mask


def _next(v, wrap):
    """v's next entry along the last axis, wrapping to entry 0 where
    ``wrap`` (a static shift, as the JAX package's)."""
    return torch.where(wrap, v[..., :1], torch.roll(v, -1, dims=-1))


def _select(v, pos, kpos):
    """v at position ``pos`` [...] as a one-hot masked sum over [..., H]
    (0 where pos is out of range)."""
    return torch.where(kpos == pos[..., None], v, torch.zeros_like(v)).sum(-1)


def build_corridor(origin_x, origin_y, pts, mask, cfg: CorridorConfig,
                   max_constraints: int):
    """Corridors (BuildCorridor, corridor.cc:122-263) for origins [...] and
    seed sets pts [..., K, 2], mask [..., K].

    Returns (planes [..., KC, 3], plane_mask [..., KC], polygon
    [..., KC, 2], poly_mask [..., KC], ok [...])."""
    dtype, dev = pts.dtype, pts.device
    K = pts.shape[-2]
    R = cfg.radius
    ox = origin_x[..., None]
    oy = origin_y[..., None]

    dx = pts[..., 0] - ox
    dy = pts[..., 1] - oy
    norm = hypot(dx, dy)
    valid = (mask & (dx.abs() <= cfg.max_diff_x)
             & (dy.abs() <= cfg.max_diff_y) & (norm >= 1e-10))

    # safe_radius: norm of the LAST valid point with norm < R
    # (corridor.cc:166-169)
    below = valid & (norm < R)
    arange_k = torch.arange(K, device=dev)
    rev_pos = torch.where(below, arange_k, torch.full_like(arange_k, -1))
    last = torch.argmax(rev_pos, dim=-1)
    safe_radius = torch.where(
        below.any(dim=-1), torch.gather(norm, -1, last[..., None])[..., 0],
        torch.full_like(origin_x, R))

    # sphere flip (corridor.cc:173-174); origin appended at index K
    one = torch.ones_like(norm)
    scale = torch.where(valid, 2.0 * R / torch.where(norm > 0, norm, one)
                        - 1.0, torch.zeros_like(norm))
    fx = dx * scale
    fy = dy * scale
    z1 = torch.zeros_like(ox)
    o1 = torch.ones_like(ox)
    flip = torch.stack([torch.cat([fx, z1], -1), torch.cat([fy, z1], -1)],
                       dim=-1)
    flip_mask = torch.cat([valid, torch.ones_like(valid[..., :1])], dim=-1)
    ok = valid.sum(dim=-1) >= 4  # corridor.cc:178-181

    # hull 1 (flipped space), the ORIGINAL coordinates riding through the
    # hull's sorts as payload (the origin slot carries the origin pose);
    # hull vertices come back compacted into the leading slots, so the rest
    # runs at the narrow hull_max width (exact when hull 1 has <= hull_max
    # vertices, flagged through ok otherwise)
    zero = torch.zeros_like(dx)
    pay = (torch.cat([torch.where(valid, pts[..., 0], zero), ox], -1),
           torch.cat([torch.where(valid, pts[..., 1], zero), oy], -1),
           torch.cat([zero, o1], -1))
    _, h1_mask, h1_count, (vx, vy, org) = convex_hull_masked(
        flip, flip_mask, payload=pay)
    H = min(cfg.hull_max, K + 1)
    ok = ok & (h1_count <= H)
    h1_mask = h1_mask[..., :H]
    vx = vx[..., :H]
    vy = vy[..., :H]
    is_origin = (org[..., :H] > 0.5) & h1_mask

    # interior point (corridor.cc:200-215)
    origin_on_hull = is_origin.any(dim=-1)
    opos = torch.argmax(is_origin.to(torch.int8), dim=-1)
    prev = torch.remainder(opos - 1, h1_count)
    nxt = torch.remainder(opos + 1, h1_count)
    kpos = torch.arange(H, device=dev)
    ix = (_select(vx, prev, kpos) + origin_x + _select(vx, nxt, kpos)
          ) / 3.0 - origin_x
    iy = (_select(vy, prev, kpos) + origin_y + _select(vy, nxt, kpos)
          ) / 3.0 - origin_y
    d = torch.sqrt(ix * ix + iy * iy)
    d = torch.where(d > 0, d, torch.ones_like(d))
    interior_x = torch.where(origin_on_hull,
                             0.99 * safe_radius * ix / d + origin_x, origin_x)
    interior_y = torch.where(origin_on_hull,
                             0.99 * safe_radius * iy / d + origin_y, origin_y)

    # hull 2 over the mapped-back vertices (corridor.cc:217-218), payload =
    # hull-1 position; sorted ascending it is the reference's walk order
    # (corridor.cc:221-233)
    vpts = torch.stack([vx, vy], dim=-1)
    h2pts, h2_mask, h2_count, (h2_pos,) = convex_hull_masked(
        vpts, h1_mask, payload=(kpos.expand(h1_mask.shape),))
    h2_pos = torch.where(h2_mask, h2_pos, torch.full_like(h2_pos, H + 1))
    q, o = torch.sort(h2_pos, dim=-1, stable=True)
    ax = torch.gather(h2pts[..., 0], -1, o)
    ay = torch.gather(h2pts[..., 1], -1, o)

    # edge normals between consecutive hull-2 vertices in walk order
    wrap = kpos == (h2_count - 1)[..., None]
    rayx = _next(ax, wrap) - ax
    rayy = _next(ay, wrap) - ay
    nlen = hypot(rayy, rayx)
    nlen = torch.where(nlen > 0, nlen, torch.ones_like(nlen))
    nx_e = rayy / nlen   # outward normal for a CCW hull (corridor.cc:224-225)
    ny_e = -rayx / nlen

    # each hull-1 vertex position k to the covering hull-2 edge: j = last
    # q <= k (cyclic; k < q[0] wraps to the last edge)
    j = (q[..., None, :] <= kpos[:, None]).sum(dim=-1) - 1   # [..., H]
    last_e = (h2_count - 1)[..., None]
    j = torch.where(j < 0, last_e, torch.minimum(j, last_e))
    sel = j[..., :, None] == kpos
    na = torch.where(sel, nx_e[..., None, :], 0.0).sum(-1)
    nb = torch.where(sel, ny_e[..., None, :], 0.0).sum(-1)
    cc = ((vx - interior_x[..., None]) * na
          + (vy - interior_y[..., None]) * nb)
    cons_mask = h1_mask

    # dual points (corridor.cc:235-239)
    cc_safe = torch.where(cc.abs() > 1e-12, cc, torch.full_like(cc, 1e-12))
    zh = torch.zeros_like(cc)
    dual = torch.stack([torch.where(cons_mask, na / cc_safe, zh),
                        torch.where(cons_mask, nb / cc_safe, zh)], dim=-1)

    # dual hull, clockwise (corridor.cc:241-242): the CCW hull reversed
    dh, dh_mask, dh_count = convex_hull_masked(dual, cons_mask)
    ridx = torch.remainder((dh_count - 1)[..., None] - kpos,
                           torch.clamp(dh_count, min=1)[..., None])
    rsel = ridx[..., :, None] == kpos
    dhx = torch.where(dh_mask, torch.where(rsel, dh[..., None, :, 0],
                                           0.0).sum(-1), zh)
    dhy = torch.where(dh_mask, torch.where(rsel, dh[..., None, :, 1],
                                           0.0).sum(-1), zh)

    # polygon vertices (corridor.cc:244-249)
    dwrap = kpos == (dh_count - 1)[..., None]
    rx2 = _next(dhx, dwrap) - dhx
    ry2 = _next(dhy, dwrap) - dhy
    cpoly = ry2 * dhx - rx2 * dhy
    cpoly_safe = torch.where(cpoly.abs() > 1e-12, cpoly,
                             torch.full_like(cpoly, 1e-12))
    px = interior_x[..., None] + ry2 / cpoly_safe
    py = interior_y[..., None] - rx2 / cpoly_safe

    # final constraints from the polygon's edges (corridor.cc:251-261)
    rpx = _next(px, dwrap) - px
    rpy = _next(py, dwrap) - py
    a_f = -rpy
    b_f = rpx
    c_f = a_f * px + b_f * py
    planes = torch.stack([a_f, b_f, c_f], dim=-1)

    # a polygon with more than KC edges would be truncated, leaving the
    # corridor less constrained than computed: flagged through ok
    KC = max_constraints
    ok = ok & (dh_count <= KC)
    keep = torch.arange(KC, device=dev) < dh_count[..., None]
    poly = torch.stack([px, py], dim=-1)
    if KC <= H:
        planes, poly = planes[..., :KC, :], poly[..., :KC, :]
    else:
        pad = (0, 0, 0, KC - H)
        planes = torch.nn.functional.pad(planes, pad)
        poly = torch.nn.functional.pad(poly, pad)
    planes_out = torch.where(keep[..., None], planes, 0.0)
    poly_out = torch.where(keep[..., None], poly, 0.0)
    return planes_out, keep, poly_out, keep, ok


def lane_boundary_sample(points: np.ndarray, segment_length: float):
    """LaneBoundarySample (corridor.cc:307-320): greedy resampling of the
    barrier polyline every ~segment_length metres (host)."""
    pts = np.asarray(points)
    kept = [pts[0]]
    last = pts[0]
    for p in pts:
        if np.hypot(p[0] - last[0], p[1] - last[1]) >= segment_length - 1e-10:
            kept.append(p)
            last = p
    return np.asarray(kept)


def lane_constraints(left_barrier: np.ndarray, right_barrier: np.ndarray,
                     cfg: CorridorConfig, dtype=np.float64):
    """CalLeft/RightLaneConstraints (corridor.cc:265-305): half-planes +
    generating segments as numpy arrays, padded to cfg.max_lane_segments.
    Left segments run reversed (corridor.cc:279-280) so that the inward
    side satisfies a x + b y <= c; right segments run forward (:300-301)."""
    S = cfg.max_lane_segments

    def build(boundary, reverse):
        sampled = lane_boundary_sample(boundary, cfg.lane_segment_length)
        n = len(sampled) - 1
        if n > S:
            raise ValueError(f"max_lane_segments={S} < needed {n}")
        planes = np.zeros((S, 3), dtype)
        segs = np.zeros((S, 2, 2), dtype)
        mask = np.zeros((S,), bool)
        for i in range(1, len(sampled)):
            if reverse:
                s_pt, e_pt = sampled[i], sampled[i - 1]
            else:
                s_pt, e_pt = sampled[i - 1], sampled[i]
            nvec = e_pt - s_pt
            a, b = nvec[1], -nvec[0]
            c = a * s_pt[0] + b * s_pt[1]
            planes[i - 1] = (a, b, c)
            segs[i - 1] = (s_pt, e_pt)
            mask[i - 1] = True
        return planes, segs, mask

    lp, lsg, lm = build(left_barrier, True)
    rp, rsg, rm = build(right_barrier, False)
    return lp, lsg, lm, rp, rsg, rm


def lane_constraints_batch(left_barrier, left_mask, right_barrier,
                           right_mask, cfg: CorridorConfig,
                           dtype=np.float64):
    """lane_constraints of R roads in one vectorised pass: per-side
    polylines [R, NB, 2] padded to the longest, each road's points where
    its mask [R, NB] is set (a prefix). The greedy resampling steps
    through the points once for all roads; the six arrays come back
    stacked [R, S, ...], each road's bit for bit lane_constraints'."""
    S = cfg.max_lane_segments
    thresh = cfg.lane_segment_length - 1e-10

    def build(boundary, mask, reverse):
        pts = np.asarray(boundary)         # in its own type, as one road's
        valid = np.asarray(mask, bool)
        R = pts.shape[0]
        rows = np.arange(R)
        kept = np.zeros((R, S + 2, 2), pts.dtype)   # a slot past S: overflow
        kept[:, 0] = pts[:, 0]
        last = pts[:, 0].copy()
        n = np.ones(R, np.int64)
        for j in range(pts.shape[1]):
            p = pts[:, j]
            take = valid[:, j] & (np.hypot(p[:, 0] - last[:, 0],
                                           p[:, 1] - last[:, 1]) >= thresh)
            kept[rows[take], np.minimum(n[take], S + 1)] = p[take]
            last[take] = p[take]
            n += take
        if int(n.max()) - 1 > S:
            raise ValueError(f"max_lane_segments={S} < needed "
                             f"{int(n.max()) - 1}")
        seg = np.arange(S)[None, :] < (n - 1)[:, None]        # [R, S]
        s_pt, e_pt = kept[:, :S], kept[:, 1:S + 1]
        if reverse:
            s_pt, e_pt = e_pt, s_pt
        nvec = e_pt - s_pt
        a, b = nvec[..., 1], -nvec[..., 0]
        c = a * s_pt[..., 0] + b * s_pt[..., 1]
        planes = np.where(seg[..., None], np.stack([a, b, c], -1), 0.0)
        segs = np.where(seg[..., None, None], np.stack([s_pt, e_pt], -2),
                        0.0)
        return planes.astype(dtype), segs.astype(dtype), seg

    lp, lsg, lm = build(left_barrier, left_mask, True)
    rp, rsg, rm = build(right_barrier, right_mask, False)
    return lp, lsg, lm, rp, rsg, rm


@spanned("corridors")
def plan_corridors(scns: Scenario, traj: Traj, cfg: CorridorConfig,
                   lane: tuple) -> CorridorSet:
    """Corridor::Plan (corridor.cc:17-54) for a batch: per-knot corridors
    along the coarse trajectories [B, N], and the lane constraints
    (``lane``: lane_constraints' six arrays of the batch's one road,
    broadcast over it; or, where each lane is on a road of its own, the
    six with the batch axis leading, each lane's own road's, as
    pipeline.lane_roads gathers them). Scenarios are processed in chunks
    of PAIRS_PER_CHUNK hull pairs."""
    B, N = traj.x.shape
    dev, dtype = traj.x.device, traj.x.dtype
    K1 = cfg.max_points + 1
    chunk = max(1, PAIRS_PER_CHUNK // (N * K1 * K1))
    parts = []
    for i in range(0, B, chunk):
        with span("corridors.chunk"):
            scn = scns.map(lambda a: a[i:i + chunk])
            tr = traj.map(lambda a: a[i:i + chunk])
            dyn = query_dynamic_points_grid(scn, tr.time)
            pts, mask = corridor_seed_points(scn, tr.x, tr.y, tr.theta, cfg,
                                             cfg.max_points, dyn)
            parts.append(build_corridor(tr.x, tr.y, pts, mask, cfg,
                                        cfg.max_constraints))
    planes, pmask, polys, polymask, ok = (torch.cat(v) for v in zip(*parts))

    per_lane = lane[2].ndim == 2          # masks [B, S], or [S] shared

    def shared(a):
        # a lane's own road's arrays are gathered on the device already
        a = a.to(dev) if per_lane else upload(a, device=dev)
        if a.is_floating_point():
            a = a.to(dtype)
        return a if per_lane else a.expand((B,) + a.shape)

    lp, lsg, lm, rp, rsg, rm = (shared(a) for a in lane)
    return CorridorSet(
        planes=planes, plane_mask=pmask, polygons=polys, poly_mask=polymask,
        left_planes=lp, left_segs=lsg, left_mask=lm, right_planes=rp,
        right_segs=rsg, right_mask=rm, ok=ok)
