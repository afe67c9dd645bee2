"""World-model collision and obstacle queries (PyTorch counterpart of
cilqr_tpu/world.py), over batched Scenario tensors.

Ported: what the DP's frenet mode with a RoadSpec, the corridors' seed
query and the output re-check use. Road-barrier membership comes in two
modes here: ``exact`` (brute-force point-in-box over every barrier point,
environment.cpp:46-81) and ``frenet`` with the road's RoadSpec (the
finite per-segment test of ``barrier_hit_road_spec``). The ``grid`` mode
and its BarrierGrid, and frenet mode's station-field stand-in without a
RoadSpec, are not ported (ROADMAP.md, queue 1, item 1: the rest of world,
geometry and dp).

A Scenario here carries a leading batch axis [B]; queries are [B, ...].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .geometry import _first_valid_fill, convex_overlap_aabb
from .types import Scenario

K_MATH_EPS = 1e-10


def barrier_points_in_box_exact(barrier_xy, barrier_mask, minx, miny, maxx,
                                maxy):
    """Exact point-in-closed-box count (environment.cpp:74-78): barrier
    points [B, NB, 2] against boxes [B, *q]."""
    nq = minx.dim() - 1
    px = barrier_xy[..., 0].reshape(
        (barrier_xy.shape[0],) + (1,) * nq + (-1,))
    py = barrier_xy[..., 1].reshape(px.shape)
    m = barrier_mask.reshape(px.shape)
    inside = ((px >= minx[..., None]) & (px <= maxx[..., None])
              & (py >= miny[..., None]) & (py <= maxy[..., None]) & m)
    return inside.sum(dim=-1)


def static_obstacle_overlap(scn: Scenario, minx, miny, maxx, maxy):
    """Any static obstacle polygon overlapping the axis-aligned boxes
    [B, *q] (environment.cpp:46-52)."""
    B, KS = scn.static_obs.shape[:2]
    shape = (B,) + (1,) * (minx.dim() - 1) + (KS,)
    polys = scn.static_obs.reshape(shape + (4, 2))
    ones = torch.ones(polys.shape[:-1], dtype=torch.bool,
                      device=polys.device)
    hit = convex_overlap_aabb(polys, ones, minx[..., None], miny[..., None],
                              maxx[..., None], maxy[..., None])
    return (hit & scn.static_mask.reshape(shape)).any(dim=-1)


def _uniform_time_index(times, q):
    """upper_bound index #{i: times[i] <= q} for a NEAR-UNIFORM sorted
    table, un-clipped: arithmetic guess from the leading spacing plus an
    exact +-1 fix-up against the stored values (the JAX package's
    arithmetic; exact whenever the true index is within 1 of the guess).
    times [..., T] (one track per leading index), q [..., *r] -> int64."""
    T = times.shape[-1]
    nb = times.dim() - 1
    t0 = times[..., 0]
    h = times[..., 1] - t0
    h = torch.where(h > 0, h, torch.ones_like(h))

    def rows(v):
        return v.reshape(v.shape + (1,) * (q.dim() - nb))

    def at(i):
        flat = i.reshape(i.shape[:nb] + (-1,))
        return torch.gather(times, -1, flat).reshape(i.shape)

    guess = (torch.floor((q - rows(t0)) / rows(h)) + 1).to(torch.int64)
    r = torch.clamp(guess, 0, T)
    r = r + ((at(torch.clamp(r, 0, T - 1)) <= q) & (r < T)).to(r.dtype)
    r = r - ((at(torch.clamp(r - 1, 0, T - 1)) > q) & (r > 0)).to(r.dtype)
    return r


def _dyn_polygons_at(scn: Scenario, times, eps=0.0):
    """Polygon + active flag of every dynamic obstacle at each query time:
    the first sample with timestamp > time - eps (upper_bound; eps=0 is
    CheckDynamicCollision env.cpp:114-131, eps=kMathEpsilon
    QueryDynamicObstacles :133-151). times [B, T'] (or [T'], shared) ->
    (polys [B, T', KD, 4, 2], active [B, T', KD])."""
    B, KD, TD = scn.dyn_times.shape
    if times.dim() == 1:
        times = times.expand(B, -1)
    tq = times[:, None, :].expand(B, KD, times.shape[-1])     # [B, KD, T']
    L = scn.dyn_len.to(torch.int64)[..., None]                 # [B, KD, 1]
    idx = torch.minimum(torch.clamp(_uniform_time_index(scn.dyn_times,
                                                        tq - eps), min=0),
                        L - 1)
    idx = torch.where(idx < 0, idx + TD, idx)   # an empty track: JAX's -1
    polys = torch.gather(scn.dyn_obs, 2, idx[..., None, None].expand(
        B, KD, idx.shape[-1], 4, 2))                           # [B,KD,T',4,2]
    t_last = torch.gather(scn.dyn_times, 2, torch.clamp(L - 1, min=0))
    active = (scn.dyn_mask[..., None]
              & (scn.dyn_times[..., :1] <= tq + eps)
              & (t_last >= tq - eps))
    return polys.transpose(1, 2), active.transpose(1, 2)


def dyn_polys_at(scn: Scenario, times):
    """Polygon + active flag of every dynamic obstacle at each query time
    (eps=0): times [B, T'] or [T'] -> (polys [B, T', KD, 4, 2], active
    [B, T', KD]). Probes taken at these times look the obstacles up here
    once instead of once per probe."""
    return _dyn_polygons_at(scn, times, eps=0.0)


class DilatedPolys(NamedTuple):
    """Half-plane form of convex polygons dilated by an axis-aligned box of
    half-size ``half`` (Minkowski sum P (+) [-half, half]^2): box(c, half)
    overlaps P iff c lies in it, the same separating-axes predicate as
    convex_overlap_aabb. Fields broadcast over the polygons' batch shape;
    E = edge count (degenerate padded edges get (-inf, +inf))."""

    nx: torch.Tensor    # [..., E] edge-normal x
    ny: torch.Tensor    # [..., E] edge-normal y
    lo: torch.Tensor    # [..., E] expanded projection lower bound
    hi: torch.Tensor    # [..., E] expanded projection upper bound
    minx: torch.Tensor  # [...] poly AABB (+/- half)
    miny: torch.Tensor
    maxx: torch.Tensor
    maxy: torch.Tensor
    valid: torch.Tensor  # [...] bool

    def map(self, fn) -> "DilatedPolys":
        return DilatedPolys(*(fn(v) for v in self))


def dilate_polys(polys, mask, half, rect: bool = False) -> DilatedPolys:
    """DilatedPolys of padded polygons [..., K, 2] with a per-vertex mask
    ([..., K] or broadcastable; pass a per-polygon flag as
    ``flag[..., None]``). rect=True: the polygons are rectangles, so only
    the first two edge directions are kept (each slab covers its opposite
    edge exactly)."""
    pts, m = _first_valid_fill(polys, mask)
    px = pts[..., 0]
    py = pts[..., 1]
    nxt = torch.roll(pts, -1, dims=-2)
    ex = nxt[..., 0] - px
    ey = nxt[..., 1] - py
    deg = (ex.abs() + ey.abs()) <= 0
    pn = (px[..., None, :] * ey[..., :, None]
          - py[..., None, :] * ex[..., :, None])
    hn = half * (ey.abs() + ex.abs())
    big = torch.tensor(math.inf, dtype=polys.dtype, device=polys.device)
    k = 2 if rect else pts.shape[-2]
    return DilatedPolys(
        nx=ey[..., :k], ny=-ex[..., :k],
        lo=torch.where(deg, -big, pn.amin(dim=-1) - hn)[..., :k],
        hi=torch.where(deg, big, pn.amax(dim=-1) + hn)[..., :k],
        minx=px.amin(dim=-1) - half, maxx=px.amax(dim=-1) + half,
        miny=py.amin(dim=-1) - half, maxy=py.amax(dim=-1) + half,
        valid=m.any(dim=-1))


def point_hits_dilated(d: DilatedPolys, cx, cy):
    """Membership of points (cx, cy) in each dilated polygon, i.e. the
    box(point, half)-overlaps-polygon predicate; cx, cy broadcast against
    the polygons' batch axes (rank-align with trailing singletons)."""
    t = cx[..., None] * d.nx + cy[..., None] * d.ny
    in_edges = ((t >= d.lo) & (t <= d.hi)).all(dim=-1)
    in_box = (cx >= d.minx) & (cx <= d.maxx) & (cy >= d.miny) & (cy <= d.maxy)
    return d.valid & in_edges & in_box


def barrier_hit_road_spec(h, cx, cy, spec, pad=0.05):
    """Finite-extent road-barrier membership from the closed-form road
    recipe (scenario.RoadSpec), for boxes of half-size h at (cx, cy) of any
    shape: each road segment's boundary on both sides tested as a finite
    curve (straights: box against the segment by a conservative SAT; arcs:
    the box against the ring, exact, and against a conservative angular
    half-plane), extents one row step longer at each end and padded by
    ``pad``. Conservative-complete with respect to the 0.1 m sampled
    barrier points. Every per-segment constant is computed on the host in
    float64 from the spec's values; the per-probe work is multiplies, adds,
    abs and compares."""
    hp = h + pad
    res = float(spec.h)
    is_arc = np.asarray(spec.is_arc)
    cnt = np.asarray(spec.count, np.float64)
    kap = np.asarray(spec.kappa, np.float64)
    ang0 = np.asarray(spec.ang0, np.float64)
    dang = np.asarray(spec.dang, np.float64)
    xc = np.asarray(spec.xc, np.float64)
    yc = np.asarray(spec.yc, np.float64)
    x0 = np.asarray(spec.x0, np.float64)
    y0 = np.asarray(spec.y0, np.float64)
    stepx = np.asarray(spec.stepx, np.float64)
    stepy = np.asarray(spec.stepy, np.float64)
    sides = (float(spec.lb), -float(spec.rb))

    hit = torch.zeros(cx.shape, dtype=torch.bool, device=cx.device)
    for g in range(len(is_arc)):
        if not is_arc[g]:
            dx_, dy_ = stepx[g] / res, stepy[g] / res  # unit direction
            L = (cnt[g] - 1.0) * res
            for u in sides:
                p0x = x0[g] + stepx[g] - u * dy_ - res * dx_
                p0y = y0[g] + stepy[g] + u * dx_ - res * dy_
                p1x = p0x + (L + 2 * res) * dx_
                p1y = p0y + (L + 2 * res) * dy_
                lox, hix = min(p0x, p1x) - hp, max(p0x, p1x) + hp
                loy, hiy = min(p0y, p1y) - hp, max(p0y, p1y) + hp
                nslack = hp * (abs(dy_) + abs(dx_))
                ncx = -dy_ * p0x + dx_ * p0y
                s = (-dy_) * cx + dx_ * cy - ncx
                hit = hit | ((cx >= lox) & (cx <= hix) & (cy >= loy)
                             & (cy <= hiy) & (s.abs() <= nslack))
        else:
            inv = 1.0 / kap[g]
            span = (cnt[g] - 1.0) * dang[g]
            hw = min(abs(span) / 2 + abs(dang[g]), np.pi)
            adx = cx - xc[g]
            ady = cy - yc[g]
            addx = adx.abs()
            addy = ady.abs()
            pdx = torch.clamp(addx - hp, min=0.0)
            pdy = torch.clamp(addy - hp, min=0.0)
            dmin2 = pdx * pdx + pdy * pdy
            sdx = addx + hp
            sdy = addy + hp
            dmax2 = sdx * sdx + sdy * sdy
            for u in sides:
                rb = abs(inv - u)
                ring = (dmin2 <= rb * rb) & (rb * rb <= dmax2)
                if hw >= np.pi:
                    hit = hit | ring
                    continue
                refl = np.pi if np.sign(kap[g]) * (inv - u) < 0 else 0.0
                mid = ang0[g] + refl + span / 2
                cmid, smid = np.cos(mid), np.sin(mid)
                thresh = rb * np.cos(hw) - hp * (abs(cmid) + abs(smid))
                ang = (adx * cmid + ady * smid) >= thresh
                hit = hit | (ring & ang)
    return hit


def check_optimization_collision(scn: Scenario, x, y, theta, veh_radius,
                                 r2x, f2x, collision_buffer=0.0,
                                 mode: str = "frenet", dyn_polys=None,
                                 dilated=None, road_spec=None):
    """Two-disc collision probe (Environment::CheckOptimizationCollision,
    environment.cpp:92-112): axis-aligned boxes of half-size
    radius+buffer at the front and rear disc centres, tested against the
    static polygons, the road barrier and the dynamic obstacles. Probes
    x, y, theta [B, ..., T'].

    dyn_polys: (polys [B, T', KD, 4, 2], active [B, T', KD]) from
    dyn_polys_at, the dynamic obstacles at the probes' times: the probes'
    TRAILING axis is the time axis. dilated: (static DilatedPolys, dynamic
    DilatedPolys) for this call's half, already shaped to broadcast
    against the probes with a trailing polygon axis (the DP's form); it
    replaces both SAT passes. One of the two is required (the per-probe
    track lookup of the JAX package's ``time`` argument is not ported).

    mode "frenet": the road's RoadSpec (barrier_hit_road_spec); mode
    "exact": every barrier point. Mode "grid", and "frenet" without a
    RoadSpec, are not ported (ROADMAP.md, queue 1, item 1)."""
    if mode not in ("frenet", "exact") or (mode == "frenet"
                                           and road_spec is None):
        raise NotImplementedError(
            f"collision mode {mode!r} without a RoadSpec is not ported (the "
            f"BarrierGrid and the grid mode, the frenet station-field "
            f"stand-in: ROADMAP.md, queue 1, item 1: the rest of world, "
            f"geometry and dp)")
    if dyn_polys is None and dilated is None:
        raise ValueError("check_optimization_collision: pass dyn_polys or "
                         "dilated")
    half = veh_radius + collision_buffer
    ct = torch.cos(theta)
    st = torch.sin(theta)
    xr = x + r2x * ct
    yr = y + r2x * st
    xf = x + f2x * ct
    yf = y + f2x * st

    def box_hit(cx, cy):
        minx, maxx = cx - half, cx + half
        miny, maxy = cy - half, cy + half
        if dilated is not None:
            sd, dd = dilated
            hit = point_hits_dilated(sd, cx[..., None],
                                     cy[..., None]).any(dim=-1)
        else:
            hit = static_obstacle_overlap(scn, minx, miny, maxx, maxy)
        if mode == "frenet":
            hit = hit | barrier_hit_road_spec(half, cx, cy, road_spec)
        else:
            cnt = barrier_points_in_box_exact(scn.barrier_xy,
                                              scn.barrier_mask, minx, miny,
                                              maxx, maxy)
            hit = hit | (cnt > 0)
        if dilated is not None:
            hit = hit | point_hits_dilated(dd, cx[..., None],
                                           cy[..., None]).any(dim=-1)
        else:
            polys, active = dyn_polys       # [B, T', KD, 4, 2], [B, T', KD]
            nq = cx.dim() - 2
            B, Tq, KD = active.shape
            shape = (B,) + (1,) * nq + (Tq, KD)
            ones = torch.ones(shape + (4,), dtype=torch.bool,
                              device=cx.device)
            hd = convex_overlap_aabb(
                polys.reshape(shape + (4, 2)), ones, minx[..., None],
                miny[..., None], maxx[..., None], maxy[..., None])
            hit = hit | (hd & active.reshape(shape)).any(dim=-1)
        return hit

    return box_hit(xf, yf) | box_hit(xr, yr)


def query_dynamic_points(scn: Scenario, time):
    """Corner points of the dynamic obstacles active at ``time`` [B]
    (Environment::QueryDynamicObstaclesPoints, environment.cpp:167-182):
    (points [B, KD*4, 2], mask [B, KD*4])."""
    polys, active = _dyn_polygons_at(scn, time[:, None], eps=K_MATH_EPS)
    B, _, KD = active.shape
    return (polys.reshape(B, KD * 4, 2),
            active.reshape(B, KD, 1).expand(B, KD, 4).reshape(B, KD * 4))


def query_dynamic_points_grid(scn: Scenario, times):
    """query_dynamic_points for all knot times at once: times [B, N] ->
    (points [B, N, KD*4, 2], mask [B, N, KD*4]). The upper-bound index is
    its definition, #{i < len: track_time[i] <= q - eps}, a compare and
    count over the track (exact for any sorted table); the padded tail is
    excluded through dyn_len."""
    B, KD, T = scn.dyn_times.shape
    N = times.shape[1]
    eps = K_MATH_EPS
    tvalid = (torch.arange(T, device=times.device)[None, None, :]
              < scn.dyn_len[..., None])                       # [B, KD, T]
    cnt = ((scn.dyn_times[:, None] <= (times - eps)[:, :, None, None])
           & tvalid[:, None]).sum(dim=-1)                     # [B, N, KD]
    L = scn.dyn_len.to(torch.int64)[:, None, :]
    idx = torch.minimum(cnt, torch.clamp(L - 1, min=0))
    corners = torch.gather(
        scn.dyn_obs, 2, idx.transpose(1, 2)[..., None, None].expand(
            B, KD, N, 4, 2)).transpose(1, 2)                  # [B,N,KD,4,2]
    t0 = scn.dyn_times[..., 0][:, None, :]
    t_last = torch.where(tvalid, scn.dyn_times,
                         torch.full_like(scn.dyn_times, -math.inf)
                         ).amax(dim=-1)[:, None, :]
    tq = times[:, :, None]
    active = (scn.dyn_mask[:, None, :] & (t0 <= tq + eps)
              & (t_last >= tq - eps))                         # [B, N, KD]
    mask = active[..., None].expand(B, N, KD, 4).reshape(B, N, KD * 4)
    return corners.reshape(B, N, KD * 4, 2), mask
