"""World-model collision and obstacle queries (PyTorch counterpart of
cilqr_tpu/world.py), over batched Scenario tensors.

Road-barrier membership has the JAX package's three modes:

- ``exact``: brute-force point-in-box over every barrier point
  (environment.cpp:46-81), in chunks of points so that its temporaries
  stay bounded (``EXACT_TESTS_PER_CHUNK``);
- ``grid``: the integral image of a 0.1 m occupancy grid of the barrier
  points (BarrierGrid, built once per road in numpy), four gathers a box,
  or one int8 gather from the dilated table for the grid's own half-size;
  where every lane has a road of its own, each lane's dilated table out of
  one device pool (RoadLibrary, built on the device in one batched pass;
  LaneGrid, a batch's view of it);
- ``frenet``: with the road's RoadSpec, the finite per-segment test
  (``barrier_hit_road_spec``); without it, the station-field stand-in
  (``barrier_hit_frenet``: the boundary circle or line of the segment in
  effect at the probe's station).

A Scenario here carries a leading batch axis [B]; queries are [B, ...].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .geometry import (_first_valid_fill, box_corners, convex_overlap,
                       convex_overlap_aabb, hypot, point_in_oriented_box)
from .profiling import upload
from .types import Scenario

K_MATH_EPS = 1e-10

# point-in-box tests of the exact mode held at once (probes x barrier
# points): a bool temporary of this many bytes, a few of them alive
EXACT_TESTS_PER_CHUNK = 1 << 27


class BarrierGrid(NamedTuple):
    """Integral image of barrier-point counts: integral[i, j] = number of
    points with cell_y < i and cell_x < j (on the device of the queries).

    dilated/half/span: box-occupancy tables for ONE query half-size
    (build_barrier_grid(half=...)): dilated[a, b, i+OFF, j+OFF] = any
    barrier point with cell_y in [i, i+span+a] and cell_x in [j,
    j+span+b], span = floor(2*half/cell), OFF = span+2. A box [c-half,
    c+half] covers span+1 or span+2 cells on each axis, so its membership
    is one int8 gather, bit-exact to the integral path when both take the
    same cell indices. ``origin`` is in the type the build was asked for;
    a lookup computes its cell indices in the promotion of that type and
    the queries' (the JAX package's origin is float64 with 64-bit types
    enabled, float32 otherwise)."""

    integral: torch.Tensor             # [H+1, W+1] int32
    origin: torch.Tensor               # [2]
    cell: float
    dilated: torch.Tensor | None = None   # [2, 2, H+2*OFF, W+2*OFF] int8
    half: float | None = None
    span: int | None = None


def build_barrier_grid(barrier_xy, cell: float = 0.1, pad: float = 2.0,
                       half: float | None = None, dtype=torch.float64,
                       device="cuda") -> BarrierGrid:
    """The road's grid, built on the host in numpy (once per road, for a
    batch on one road) from barrier points [NB, 2] (numpy or a tensor, in
    their own type, as the JAX package builds from ``np.asarray``), then
    moved to ``device`` (the card unless told otherwise). With ``half``,
    also the dilated tables for one-gather box queries of that half-size
    (the DP probe's vehicle radius). ``dtype``: the origin's type. A batch
    whose lanes are on roads of their own takes build_road_library, whose
    tables equal this build's road by road."""
    if isinstance(barrier_xy, torch.Tensor):
        barrier_xy = barrier_xy.detach().cpu().numpy()
    pts = np.asarray(barrier_xy)
    lo = pts.min(axis=0) - pad
    hi = pts.max(axis=0) + pad
    W = int(np.ceil((hi[0] - lo[0]) / cell)) + 1
    H = int(np.ceil((hi[1] - lo[1]) / cell)) + 1
    ij = np.floor((pts - lo) / cell).astype(np.int64)
    grid = np.zeros((H, W), np.int32)
    np.add.at(grid, (ij[:, 1], ij[:, 0]), 1)
    integral = np.zeros((H + 1, W + 1), np.int32)
    integral[1:, 1:] = grid.cumsum(0).cumsum(1)

    dilated = None
    span = None
    if half is not None:
        span = int(np.floor(2.0 * half / cell))
        off = span + 2
        dilated = np.zeros((2, 2, H + 2 * off, W + 2 * off), np.int8)
        anchors_i = np.arange(-off, H + off)
        anchors_j = np.arange(-off, W + off)
        for a in (0, 1):
            i0 = np.clip(anchors_i, 0, H)
            i1 = np.clip(anchors_i + span + a + 1, 0, H)
            for b in (0, 1):
                j0 = np.clip(anchors_j, 0, W)
                j1 = np.clip(anchors_j + span + b + 1, 0, W)
                cnt = (integral[i1][:, j1] - integral[i0][:, j1]
                       - integral[i1][:, j0] + integral[i0][:, j0])
                dilated[a, b] = (cnt > 0).astype(np.int8)
    return BarrierGrid(
        integral=torch.as_tensor(integral, device=device),
        origin=torch.as_tensor(lo, dtype=dtype, device=device), cell=cell,
        dilated=None if dilated is None else torch.as_tensor(dilated,
                                                             device=device),
        half=half, span=span)


class RoadLibrary(NamedTuple):
    """R roads' grid-mode tables in one device pool, for batches whose
    lanes are on roads of their own (fleet replay: each vehicle on its own
    mapped road). Road r's dilated table is BarrierGrid.dilated of
    build_barrier_grid(road r's points, half=half), bit for bit, flattened
    at ``offset[r]``: [2, 2, H + 2 OFF, W + 2 OFF], OFF = span + 2. The
    integral images are not kept: a library serves box queries of its own
    half-size only.

    ``rows`` and ``lanes`` are the roads' centerline row counts and lane
    constraints (lane_constraints' six arrays with the roads' axis leading,
    padded to one S), set by pipeline.road_library."""

    dilated: torch.Tensor        # [sum_r 4 (H_r + 2 OFF)(W_r + 2 OFF)] int8
    offset: torch.Tensor         # [R] int64
    hw: torch.Tensor             # [R, 2] int64: H, W
    origin: torch.Tensor         # [R, 2]
    cell: float
    half: float
    span: int
    rows: torch.Tensor | None = None    # [R] int64
    lanes: tuple | None = None          # six tensors [R, S, ...]

    @property
    def n_roads(self) -> int:
        return self.offset.shape[0]


class LaneGrid(NamedTuple):
    """Each lane's road table out of a RoadLibrary (lane_grid): the pool,
    and the lane's table offset, H and W, origin and road index, [B] each
    ([B, 2] for hw and origin). Where a BarrierGrid takes one road for the
    batch, this takes one a lane; a lookup reads the lane's own table with
    the arithmetic of barrier_box_hit_dilated."""

    dilated: torch.Tensor
    offset: torch.Tensor
    hw: torch.Tensor
    origin: torch.Tensor
    cell: float
    half: float
    span: int
    roads: torch.Tensor
    n_roads: int

    def take(self, idx) -> "LaneGrid":
        """The lanes ``idx`` (an index or a slice of the batch)."""
        return self._replace(offset=self.offset[idx], hw=self.hw[idx],
                             origin=self.origin[idx], roads=self.roads[idx])


# grid cells of the batched build's temporaries held at once (roads of a
# chunk x their padded table's cells): int32 temporaries of ~128 MB each
LIBRARY_CELLS_PER_CHUNK = 1 << 25


def build_road_library(barrier_xy, barrier_mask, cell: float = 0.1,
                       pad: float = 2.0, half: float = 0.0,
                       dtype=torch.float64) -> RoadLibrary:
    """The dilated tables of R roads, built on the device of their barrier
    points in one batched pass (roads in chunks of
    LIBRARY_CELLS_PER_CHUNK padded cells): barrier points [R, NB, 2] in
    their own type, barrier_mask [R, NB] (a shorter road's padding masked
    out). Road by road it computes build_barrier_grid(points, cell, pad,
    half, dtype) in its own arithmetic: the bounds (exact minima less the
    pad), the cell counts (each cell index a correctly rounded division by
    the cell rounded to the points' type, as numpy divides), the integral
    image and the clipped window counts in integers. The table sizes are
    the build's own host arithmetic on the bounds, one read of them.
    ``dtype``: the origins' type."""
    pts = barrier_xy
    dev, pdt = pts.device, pts.dtype
    R = pts.shape[0]
    m = barrier_mask[..., None]
    inf = torch.full((), math.inf, dtype=pdt, device=dev)
    lo = torch.where(m, pts, inf).amin(dim=1) - pad              # [R, 2]
    hi = torch.where(m, pts, -inf).amax(dim=1) + pad
    lo_h = lo.cpu().numpy()
    hi_h = hi.cpu().numpy()
    W = [int(np.ceil((hi_h[r][0] - lo_h[r][0]) / cell)) + 1 for r in range(R)]
    H = [int(np.ceil((hi_h[r][1] - lo_h[r][1]) / cell)) + 1 for r in range(R)]
    span = int(np.floor(2.0 * half / cell))
    off = span + 2
    sizes = [4 * (h + 2 * off) * (w + 2 * off) for h, w in zip(H, W)]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    pool = torch.zeros(int(sum(sizes)), dtype=torch.int8, device=dev)
    c = torch.full((), cell, dtype=pdt, device=dev)
    ij = torch.floor((pts - lo[:, None, :]) / c).to(torch.int64)  # [R, NB, 2]
    r0 = 0
    while r0 < R:
        r1 = r0 + 1
        while r1 < R and ((r1 + 1 - r0) * (max(H[r0:r1 + 1]) + 2 * off)
                          * (max(W[r0:r1 + 1]) + 2 * off)
                          <= LIBRARY_CELLS_PER_CHUNK):
            r1 += 1
        _library_chunk(pool, starts[r0:r1], H[r0:r1], W[r0:r1], ij[r0:r1],
                       barrier_mask[r0:r1], span)
        r0 = r1
    i64 = dict(dtype=torch.int64, device=dev)
    return RoadLibrary(
        dilated=pool, offset=torch.as_tensor(starts, **i64),
        hw=torch.as_tensor(np.stack([H, W], -1), **i64),
        origin=lo.to(dtype), cell=cell, half=half, span=span)


def _library_chunk(pool, starts, H, W, ij, mask, span):
    """The dilated tables of a chunk of roads, padded to the chunk's
    largest H and W, written into the pool at each road's offset: cell
    counts by an integer scatter, the integral image by integer sums, the
    window counts from it clipped to each road's own H and W (the padding
    holds no point, so inside a road's own range the padded integral is
    the road's)."""
    dev = pool.device
    n, Hm, Wm = len(H), max(H), max(W)
    off = span + 2
    i64 = dict(dtype=torch.int64, device=dev)
    Hr = torch.as_tensor(H, **i64)[:, None]
    Wr = torch.as_tensor(W, **i64)[:, None]
    flat = ((torch.arange(n, **i64)[:, None] * Hm + ij[..., 1]) * Wm
            + ij[..., 0])[mask]
    grid = torch.zeros(n * Hm * Wm, dtype=torch.int32, device=dev)
    grid.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    integral = torch.zeros((n, Hm + 1, Wm + 1), dtype=torch.int32,
                           device=dev)
    integral[:, 1:, 1:] = grid.reshape(n, Hm, Wm).cumsum(
        1, dtype=torch.int32).cumsum(2, dtype=torch.int32)
    ai = torch.arange(-off, Hm + off, **i64)[None]               # [1, Hpm]
    aj = torch.arange(-off, Wm + off, **i64)[None]
    zero = torch.zeros((), **i64)

    def clip(v, top):
        return torch.minimum(torch.maximum(v, zero), top)

    def rows_at(i):                        # integral rows i [n, Hpm]
        return torch.gather(integral, 1, i[..., None].expand(
            n, i.shape[1], Wm + 1))

    def cols_at(t, j):                     # t [n, Hpm, Wm+1], j [n, Wpm]
        return torch.gather(t, 2, j[:, None, :].expand(
            n, t.shape[1], j.shape[1]))

    i0 = clip(ai, Hr)
    j0 = clip(aj, Wr)
    tabs = []
    for a in (0, 1):
        i1 = clip(ai + span + a + 1, Hr)
        top, bot = rows_at(i1), rows_at(i0)
        for b in (0, 1):
            j1 = clip(aj + span + b + 1, Wr)
            cnt = (cols_at(top, j1) - cols_at(bot, j1) - cols_at(top, j0)
                   + cols_at(bot, j0))
            tabs.append((cnt > 0).to(torch.int8))
    tab = torch.stack(tabs, 1)                           # [n, 4, Hpm, Wpm]
    for k in range(n):
        hp, wp = H[k] + 2 * off, W[k] + 2 * off
        pool[int(starts[k]):int(starts[k]) + 4 * hp * wp] = \
            tab[k, :, :hp, :wp].reshape(-1)


def lane_grid(library: RoadLibrary, roads) -> LaneGrid:
    """The LaneGrid of a batch whose lane i is on road ``roads[i]`` of the
    library: its offsets, sizes and origins gathered, the pool shared."""
    return LaneGrid(dilated=library.dilated, offset=library.offset[roads],
                    hw=library.hw[roads], origin=library.origin[roads],
                    cell=library.cell, half=library.half, span=library.span,
                    roads=roads, n_roads=library.n_roads)


def _cell_index(grid: BarrierGrid, v, axis):
    """floor((v - origin[axis]) / cell) as int64, computed in the
    promotion of the queries' type and the origin's. The cell size is a
    0-d tensor on the queries' device: PyTorch on a card multiplies by the
    reciprocal of a divisor given as a host scalar, which is not a
    correctly rounded division, and a probe on a cell boundary would read
    its neighbour. A LaneGrid's origins are the lanes' own (v [B, ...])."""
    wd = torch.promote_types(v.dtype, grid.origin.dtype)
    if isinstance(grid, LaneGrid):
        o = _per_lane(grid.origin[:, axis], v).to(wd)
    else:
        o = grid.origin[axis].to(wd)
    c = torch.full((), grid.cell, dtype=wd, device=v.device)
    return torch.floor((v.to(wd) - o) / c).to(torch.int64)


def _per_lane(x, like):
    """x [B] with trailing singleton axes to broadcast against like
    [B, ...]."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def barrier_points_in_box_grid(grid: BarrierGrid, minx, miny, maxx, maxy):
    """Conservative count of barrier points in closed boxes (any shape)
    from the integral image: four gathers a box."""
    H = grid.integral.shape[0] - 1
    W = grid.integral.shape[1] - 1
    i0 = torch.clamp(_cell_index(grid, miny, 1), 0, H)
    i1 = torch.clamp(_cell_index(grid, maxy, 1) + 1, 0, H)
    j0 = torch.clamp(_cell_index(grid, minx, 0), 0, W)
    j1 = torch.clamp(_cell_index(grid, maxx, 0) + 1, 0, W)
    flat = grid.integral.reshape(-1)

    def at(i, j):
        return flat[i * (W + 1) + j]

    return at(i1, j1) - at(i0, j1) - at(i1, j0) + at(i0, j0)


def barrier_box_hit_dilated(grid: BarrierGrid, minx, miny, maxx, maxy):
    """One int8 gather a box, bit-exact to (barrier_points_in_box_grid(...)
    > 0) for boxes of the grid's own half-size (BarrierGrid.dilated).
    Anchors clipped into the padded range read empty windows, so a box off
    the grid reports no hit, as the clamped integral path does. A LaneGrid
    takes each lane's own table (boxes [B, ...])."""
    if isinstance(grid, LaneGrid):
        return _lane_box_hit_dilated(grid, minx, miny, maxx, maxy)
    H = grid.integral.shape[0] - 1
    W = grid.integral.shape[1] - 1
    span = grid.span
    off = span + 2
    Hp = H + 2 * off
    Wp = W + 2 * off
    iy = _cell_index(grid, miny, 1)
    jx = _cell_index(grid, minx, 0)
    a = torch.clamp(_cell_index(grid, maxy, 1) - iy - span, 0, 1)
    b = torch.clamp(_cell_index(grid, maxx, 0) - jx - span, 0, 1)
    iyc = torch.clamp(iy + off, 0, Hp - 1)
    jxc = torch.clamp(jx + off, 0, Wp - 1)
    flat = ((a * 2 + b) * Hp + iyc) * Wp + jxc
    return grid.dilated.reshape(-1)[flat] > 0


def _lane_box_hit_dilated(grid: LaneGrid, minx, miny, maxx, maxy):
    """barrier_box_hit_dilated with each lane's own H, W and table offset
    (the same integer arithmetic, the clamps' bounds per lane)."""
    span = grid.span
    off = span + 2
    H = _per_lane(grid.hw[:, 0], minx)
    W = _per_lane(grid.hw[:, 1], minx)
    Hp = H + 2 * off
    Wp = W + 2 * off
    iy = _cell_index(grid, miny, 1)
    jx = _cell_index(grid, minx, 0)
    a = torch.clamp(_cell_index(grid, maxy, 1) - iy - span, 0, 1)
    b = torch.clamp(_cell_index(grid, maxx, 0) - jx - span, 0, 1)
    iyc = torch.minimum(torch.clamp(iy + off, min=0), Hp - 1)
    jxc = torch.minimum(torch.clamp(jx + off, min=0), Wp - 1)
    flat = (_per_lane(grid.offset, minx)
            + ((a * 2 + b) * Hp + iyc) * Wp + jxc)
    return grid.dilated[flat] > 0


def barrier_points_in_box_exact(barrier_xy, barrier_mask, minx, miny, maxx,
                                maxy):
    """Exact point-in-closed-box count (environment.cpp:74-78): barrier
    points [B, NB, 2] against boxes [B, *q], summed over chunks of points
    of at most EXACT_TESTS_PER_CHUNK tests."""
    nq = minx.dim() - 1
    shape = (barrier_xy.shape[0],) + (1,) * nq + (-1,)
    step = max(1, EXACT_TESTS_PER_CHUNK // max(1, minx.numel()))
    box = (minx[..., None], maxx[..., None], miny[..., None],
           maxy[..., None])
    count = None
    for p0 in range(0, barrier_xy.shape[-2], step):
        pts = barrier_xy[:, p0:p0 + step]
        px = pts[..., 0].reshape(shape)
        py = pts[..., 1].reshape(shape)
        m = barrier_mask[:, p0:p0 + step].reshape(shape)
        inside = ((px >= box[0]) & (px <= box[1]) & (py >= box[2])
                  & (py <= box[3]) & m).sum(dim=-1)
        count = inside if count is None else count + inside
    return count


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


def dynamic_obstacle_overlap(scn: Scenario, time, minx, miny, maxx, maxy):
    """CheckDynamicCollision (environment.cpp:114-131) over every dynamic
    obstacle, each looked up at its probe's own time: boxes [B, *q], time
    broadcastable to them."""
    time = torch.broadcast_to(time, minx.shape)
    B = minx.shape[0]
    polys, active = _dyn_polygons_at(scn, time.reshape(B, -1))
    KD = active.shape[-1]
    ones = torch.ones(polys.shape[:-1], dtype=torch.bool,
                      device=polys.device)

    def q(v):
        return v.reshape(B, -1, 1)

    hit = convex_overlap_aabb(polys, ones, q(minx), q(miny), q(maxx),
                              q(maxy))                         # [B, Q, KD]
    return (hit & active).any(dim=-1).reshape(minx.shape)


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
    big = upload(math.inf, dtype=polys.dtype, device=polys.device)
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


def _box_hits_line(h, cx, cy, px, py, cs, sn):
    """Axis-aligned boxes [c-h, c+h]^2 against the infinite lines through
    (px, py) with direction (cs, sn): a 1-D interval intersection in the
    line parameter t, |px + t cs - cx| <= h and |py + t sn - cy| <= h."""
    dx = px - cx
    dy = py - cy
    big = torch.full((), 1e9, dtype=dx.dtype, device=dx.device)

    def axis_interval(dv, a):
        small = a.abs() < 1e-6
        asafe = torch.where(small, torch.ones_like(a), a)
        p = (-h - dv) / asafe
        q = (h - dv) / asafe
        ok0 = dv.abs() <= h
        lo = torch.where(small, torch.where(ok0, -big, big),
                         torch.minimum(p, q))
        hi = torch.where(small, torch.where(ok0, big, -big),
                         torch.maximum(p, q))
        return lo, hi

    lo1, hi1 = axis_interval(dx, cs)
    lo2, hi2 = axis_interval(dy, sn)
    return torch.maximum(lo1, lo2) <= torch.minimum(hi1, hi2)


def barrier_hit_frenet(h, cx, cy, rx, ry, theta_ref, kappa, left_bound,
                       right_bound):
    """Road-barrier membership of disc boxes from the station fields at
    the probe's station alone (frenet mode without a RoadSpec): the
    boundary at lateral u is the circle of radius |1/kappa - u| around the
    curvature centre, or the offset line on a straight, and the box is
    tested against it in closed form. The segment in effect at the probe's
    station stands in for the whole box span (unsafe on tight-arc roads,
    tests/test_dp_qualification.py; barrier_hit_road_spec is the finite
    test). All inputs broadcast."""
    sn = torch.sin(theta_ref)
    cs = torch.cos(theta_ref)
    curved = kappa.abs() > 1e-6
    ksafe = torch.where(curved, kappa, torch.ones_like(kappa))
    inv = 1.0 / ksafe
    ctrx = rx - inv * sn
    ctry = ry + inv * cs

    def one_side(u):
        hit_line = _box_hits_line(h, cx, cy, rx - u * sn, ry + u * cs, cs,
                                  sn)
        rb = (inv - u).abs()
        ddx = (cx - ctrx).abs()
        ddy = (cy - ctry).abs()
        dmin = hypot(torch.clamp(ddx - h, min=0.0),
                     torch.clamp(ddy - h, min=0.0))
        dmax = hypot(ddx + h, ddy + h)
        hit_arc = (dmin <= rb) & (rb <= dmax)
        return torch.where(curved, hit_arc, hit_line)

    return one_side(left_bound) | one_side(-right_bound)


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
                                 dilated=None, road_spec=None, grid=None,
                                 frenet=None, time=None):
    """Two-disc collision probe (Environment::CheckOptimizationCollision,
    environment.cpp:92-112): axis-aligned boxes of half-size
    radius+buffer at the front and rear disc centres, tested against the
    static polygons, the road barrier and the dynamic obstacles. Probes
    x, y, theta [B, ..., T'].

    The dynamic obstacles come from one of: ``dilated`` (static
    DilatedPolys, dynamic DilatedPolys) for this call's half, shaped to
    broadcast against the probes with a trailing polygon axis (the DP's
    form; it also replaces the static SAT pass); ``dyn_polys`` (polys
    [B, T', KD, 4, 2], active [B, T', KD]) from dyn_polys_at at the
    probes' times, the probes' TRAILING axis being the time axis; or
    ``time``, broadcastable to the probes, each probe looked up at its own
    time (dynamic_obstacle_overlap).

    The road barrier by ``mode``: "grid" (the BarrierGrid ``grid``; its
    dilated table when its half is this call's), "exact" (every barrier
    point), "frenet" (``road_spec``'s finite test, else ``frenet``, the
    station fields (rx, ry, theta_ref, kappa, left_bound, right_bound) at
    each probe's station, broadcasting against the probes), "skiproad"
    (obstacles only)."""
    if mode not in ("grid", "exact", "frenet", "skiproad"):
        raise ValueError(f"unknown collision mode {mode!r}")
    if mode == "grid" and grid is None:
        raise ValueError("collision mode 'grid' needs a BarrierGrid")
    if mode == "frenet" and road_spec is None and frenet is None:
        raise ValueError("collision mode 'frenet' needs a RoadSpec or the "
                         "probes' station fields (frenet=)")
    if dyn_polys is None and dilated is None and time is None:
        raise ValueError("check_optimization_collision: pass dyn_polys, "
                         "dilated or time")
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
        if mode == "grid":
            if grid.dilated is not None and grid.half == half:
                hit = hit | barrier_box_hit_dilated(grid, minx, miny, maxx,
                                                    maxy)
            else:
                hit = hit | (barrier_points_in_box_grid(
                    grid, minx, miny, maxx, maxy) > 0)
        elif mode == "frenet":
            if road_spec is not None:
                hit = hit | barrier_hit_road_spec(half, cx, cy, road_spec)
            else:
                hit = hit | barrier_hit_frenet(half, cx, cy, *frenet)
        elif mode == "exact":
            cnt = barrier_points_in_box_exact(scn.barrier_xy,
                                              scn.barrier_mask, minx, miny,
                                              maxx, maxy)
            hit = hit | (cnt > 0)
        if dilated is not None:
            hit = hit | point_hits_dilated(dd, cx[..., None],
                                           cy[..., None]).any(dim=-1)
        elif dyn_polys is not None:
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
        else:
            hit = hit | dynamic_obstacle_overlap(scn, time, minx, miny,
                                                 maxx, maxy)
        return hit

    return box_hit(xf, yf) | box_hit(xr, yr)


def check_collision(scn: Scenario, time, cx, cy, theta, length, width):
    """Oriented ego-box collision probe (Environment::CheckCollision,
    environment.cpp:83-90): the dynamic obstacles at ``time`` (SAT
    overlap, :114-131), the static polygons, and the road-barrier points
    in the oriented box (CheckStaticCollision :46-81 with
    Box2d::IsPointIn). cx, cy, theta [B, *q]; time broadcastable to
    them."""
    B = cx.shape[0]
    nq = cx.dim() - 1
    ego = box_corners(cx, cy, theta, length, width)         # [B, *q, 4, 2]
    ego_mask = torch.ones(ego.shape[:-1], dtype=torch.bool, device=cx.device)

    def per_poly(t, k):
        return t.reshape((B,) + (1,) * nq + t.shape[1:1 + k])

    KS = scn.static_obs.shape[1]
    hit = (convex_overlap(per_poly(scn.static_obs, 3),
                          torch.ones((1,) * (nq + 1) + (KS, 4),
                                     dtype=torch.bool, device=cx.device),
                          ego[..., None, :, :], ego_mask[..., None, :])
           & per_poly(scn.static_mask, 1)).any(dim=-1)

    def pts(t):
        return t.reshape((B,) + (1,) * nq + (-1,))

    barrier_in = point_in_oriented_box(
        pts(scn.barrier_xy[..., 0]), pts(scn.barrier_xy[..., 1]),
        cx[..., None], cy[..., None], theta[..., None], length, width
    ) & pts(scn.barrier_mask)
    hit = hit | barrier_in.any(dim=-1)

    time = torch.broadcast_to(time, cx.shape)
    polys, active = _dyn_polygons_at(scn, time.reshape(B, -1))
    KD = active.shape[-1]
    polys = polys.reshape(cx.shape + (KD, 4, 2))
    dyn = convex_overlap(polys, torch.ones(polys.shape[:-1],
                                           dtype=torch.bool,
                                           device=cx.device),
                         ego[..., None, :, :], ego_mask[..., None, :])
    return hit | (dyn & active.reshape(cx.shape + (KD,))).any(dim=-1)


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
