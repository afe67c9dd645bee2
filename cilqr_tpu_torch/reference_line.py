"""Reference-line / trajectory queries (PyTorch counterpart of
cilqr_tpu/reference_line.py): DiscretizedTrajectory's lookups and
interpolation (discretized_trajectory.cpp:34-196), batched.

A table (a Traj) may carry batch axes [*b, n]; a query then has shape
[*b, *q] and looks up its own row of tables. Without batch axes on the
table, any query shape works. Tables of roads of unequal length are padded
to one n by repeating each road's last row (scenario.stack_scenario_arrays);
the uniform-grid lookups then take each table's own row count
(``centerline_rows``), and the nearest-knot projection never prefers a
repeated row to the first of its copies.
"""

from __future__ import annotations

import torch

from .geometry import hypot, slerp
from .types import Traj

TRAJ_FIELDS = ("time", "s", "x", "y", "theta", "kappa", "velocity",
               "left_bound", "right_bound", "a", "jerk", "delta",
               "delta_rate")


def _take(table, idx):
    """table[..., idx] per batch row: table [*b, n], idx [*b, *q] (int64)
    -> [*b, *q]."""
    nb = table.dim() - 1
    if nb == 0:
        return table[idx]
    flat = idx.reshape(idx.shape[:nb] + (-1,))
    return torch.gather(table, -1, flat).reshape(idx.shape)


def _rows(v, like):
    """v [*b] with trailing singleton axes to broadcast against like
    [*b, *q]."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _interp_fields(traj: Traj, i0, i1, key_arr, key):
    """Linear interpolation of every field between knots i0 and i1 at
    ``key`` along ``key_arr`` (LinearInterpolateTrajectory,
    discretized_trajectory.cpp:66-110)."""
    k0 = _take(key_arr, i0)
    k1 = _take(key_arr, i1)
    denom = k1 - k0
    near = denom.abs() < 1e-10
    w = torch.where(near, torch.zeros_like(denom),
                    (key - k0) / torch.where(near, torch.ones_like(denom),
                                             denom))

    def lin(f):
        return (1 - w) * _take(f, i0) + w * _take(f, i1)

    out = {f: lin(getattr(traj, f)) for f in TRAJ_FIELDS if f != "theta"}
    out["theta"] = slerp(_take(traj.theta, i0), k0, _take(traj.theta, i1),
                         k1, torch.where(near, k0, key))
    return Traj(**out)


def _searchsorted_left(table, q):
    nb = table.dim() - 1
    if nb == 0:
        return torch.searchsorted(table, q)
    flat = q.reshape(q.shape[:nb] + (-1,)).contiguous()
    return torch.searchsorted(table.contiguous(), flat).reshape(q.shape)


def evaluate_station(traj: Traj, station):
    """EvaluateStation (discretized_trajectory.cpp:112-123): lower bound
    by binary search (searchsorted side="left")."""
    idx = _searchsorted_left(traj.s, station)
    idx = torch.clamp(idx, 1, traj.s.shape[-1] - 1)
    return _interp_fields(traj, idx - 1, idx, traj.s, station)


def evaluate_time(traj: Traj, time):
    """EvaluateTime (discretized_trajectory.cpp:125-136)."""
    idx = _searchsorted_left(traj.time, time)
    idx = torch.clamp(idx, 1, traj.time.shape[-1] - 1)
    return _interp_fields(traj, idx - 1, idx, traj.time, time)


DP_FIELDS = ("x", "y", "theta", "kappa", "left_bound", "right_bound")


def centerline_rows(s_table):
    """Each table's own row count [*b] (int64) of station tables [*b, n]
    padded by repeating their last row: the rows below the last station,
    and the last."""
    return (s_table < s_table[..., -1:]).sum(dim=-1) + 1


def _div_rows(x, n):
    """x / n for per-table row counts n (int64, x's shape), as x / int(n)
    computes it on x's device: a true division on the CPU, on a card a
    multiplication by the reciprocal formed in x's type (PyTorch's division
    by a host scalar there)."""
    nf = n.to(x.dtype)
    if x.device.type == "cuda":
        return x * torch.reciprocal(nf)
    return x / nf


def uniform_station_index(s_table, station, rows=None):
    """Lower-bound index into a UNIFORMLY spaced station table by
    arithmetic (not searchsorted): s[i] = i*h up to accumulation noise, so
    the two can differ only within that noise of a knot, where the
    interpolant is continuous. The JAX package's arithmetic, kept as it is
    (the DP decisions follow it). rows [*b]: each table's own row count
    where the tables are padded (``centerline_rows``); None = every row."""
    n = s_table.shape[-1]
    s0 = s_table[..., 0]
    if rows is None:
        h = (s_table[..., -1] - s0) / (n - 1)
        hi = n - 1
    else:
        last = torch.gather(s_table, -1, (rows - 1)[..., None])[..., 0]
        h = _div_rows(last - s0, rows - 1)
        hi = _rows(rows - 1, station)
    idx = torch.ceil((station - _rows(s0, station))
                     / _rows(h, station)).to(torch.int64)
    if rows is None:
        return torch.clamp(idx, 1, hi)
    return torch.minimum(torch.clamp(idx, min=1), hi)


PACK_FIELDS = ("s",) + DP_FIELDS  # row layout of pack_station_rows


def pack_station_rows(traj: Traj):
    """The 7 station-query fields packed into one [*b, n, 8] row table
    (one padding column), so that a query reads two rows instead of 14
    scalars; the values are stored unchanged, so interpolating from the
    rows is bit-identical to the unpacked path."""
    cols = [getattr(traj, f) for f in PACK_FIELDS]
    cols.append(torch.zeros_like(cols[0]))
    return torch.stack(cols, dim=-1)


def _take_rows(packed, idx):
    """packed [*b, n, 8] rows at idx [*b, *q] -> [*b, *q, 8]."""
    nb = packed.dim() - 2
    if nb == 0:
        return packed[idx]
    flat = idx.reshape(idx.shape[:nb] + (-1, 1))
    rows = torch.gather(packed, -2, flat.expand(
        flat.shape[:-1] + (packed.shape[-1],)))
    return rows.reshape(idx.shape + (packed.shape[-1],))


def evaluate_station_fields(traj: Traj, station, fields=DP_FIELDS,
                            packed=None, rows=None):
    """Lean EvaluateStation: interpolate only the requested fields, at the
    uniform-grid arithmetic index. ``packed``: optional
    pack_station_rows(traj), serving all fields from two row lookups.
    ``rows``: each table's own row count (padded tables), None = all."""
    idx = uniform_station_index(traj.s, station, rows)
    i0 = idx - 1
    i1 = idx
    if packed is not None:
        r0 = _take_rows(packed, i0)
        r1 = _take_rows(packed, i1)
        col = {f: i for i, f in enumerate(PACK_FIELDS)}

        def v0(f):
            return r0[..., col[f]]

        def v1(f):
            return r1[..., col[f]]
    else:
        def v0(f):
            return _take(getattr(traj, f), i0)

        def v1(f):
            return _take(getattr(traj, f), i1)

    k0 = v0("s")
    k1 = v1("s")
    denom = k1 - k0
    near = denom.abs() < 1e-10
    w = torch.where(near, torch.zeros_like(denom),
                    (station - k0) / torch.where(near, torch.ones_like(denom),
                                                 denom))
    out = {}
    for f in fields:
        if f == "theta":
            out[f] = slerp(v0(f), k0, v1(f), k1,
                           torch.where(near, k0, station))
        else:
            out[f] = (1 - w) * v0(f) + w * v1(f)
    return out


def get_projection(traj: Traj, px, py):
    """GetProjection (discretized_trajectory.cpp:159-190): nearest knot
    (first index on ties), then chord projection over [i-1, i+1]. px, py
    [*b, *q] against a table [*b, n]. Returns (s, l, projected Traj)."""
    nb = traj.x.dim() - 1

    def tab(f):
        return f.reshape(f.shape[:nb] + (1,) * (px.dim() - nb)
                         + f.shape[-1:])

    d2 = ((tab(traj.x) - px[..., None]) ** 2
          + (tab(traj.y) - py[..., None]) ** 2)
    i = torch.argmin(d2, dim=-1)
    n = traj.x.shape[-1]
    i0 = torch.clamp(i - 1, min=0)
    i1 = torch.clamp(i + 1, max=n - 1)

    v0x = px - _take(traj.x, i0)
    v0y = py - _take(traj.y, i0)
    v1x = _take(traj.x, i1) - _take(traj.x, i0)
    v1y = _take(traj.y, i1) - _take(traj.y, i0)
    v1n = torch.sqrt(v1x * v1x + v1y * v1y)
    dot = v0x * v1x + v0y * v1y
    delta_s = torch.where(v1n > 0, dot / torch.where(
        v1n == 0, torch.ones_like(v1n), v1n), torch.zeros_like(v1n))

    has_seg = i0 < i1
    proj_seg = _interp_fields(traj, i0, i1, traj.s,
                              _take(traj.s, i0) + delta_s)
    proj_knot = _interp_fields(traj, i, i, traj.s, _take(traj.s, i))
    proj = proj_seg.map(lambda a, b: torch.where(has_seg, a, b), proj_knot)

    nrx = px - proj.x
    nry = py - proj.y
    lateral = torch.copysign(hypot(nrx, nry),
                             nry * torch.cos(proj.theta)
                             - nrx * torch.sin(proj.theta))
    return proj.s, lateral, proj


def get_cartesian(traj: Traj, station, lateral):
    """GetCartesian (discretized_trajectory.cpp:192-196)."""
    ref = evaluate_station(traj, station)
    return (ref.x - lateral * torch.sin(ref.theta),
            ref.y + lateral * torch.cos(ref.theta))


def arc_lengths(seg):
    """Accumulated lengths [0, seg_0, seg_0 + seg_1, ...] of segments
    [..., P] along the last axis: [..., P + 1]. Each row is summed in one
    fixed order, from its first segment on, in float64 and rounded to
    seg's type at each knot (what PyTorch's CPU cumsum computes). The
    card's cumsum sizes its scan tree by the number of rows, so there a
    row's sums would depend on the batch it sits in."""
    seg64 = seg.to(torch.float64)
    acc = torch.zeros_like(seg64[..., 0])
    out = [acc]
    for i in range(seg.shape[-1]):
        acc = acc + seg64[..., i]
        out.append(acc)
    return torch.stack(out, dim=-1).to(seg.dtype)


def compute_path_profile(dt, xs, ys):
    """Finite-difference path profile from xy points [..., P]: headings,
    accumulated s, speeds, accelerations, kappas
    (DiscretePointsMath::ComputePathProfile, discrete_points_math.cc:
    27-176); a zero-length segment's derivative is 0, not NaN."""
    def central_diff(v):
        d0 = v[..., 1] - v[..., 0]
        dn = v[..., -1] - v[..., -2]
        dm = 0.5 * (v[..., 2:] - v[..., :-2])
        return torch.cat([d0[..., None], dm, dn[..., None]], dim=-1)

    dxs = central_diff(xs)
    dys = central_diff(ys)
    headings = torch.atan2(dys, dxs)

    s = arc_lengths(torch.sqrt(torch.diff(xs) ** 2 + torch.diff(ys) ** 2))

    speeds = torch.diff(s) / dt
    speeds = torch.cat([speeds, speeds[..., -1:]], dim=-1)
    accels = torch.diff(speeds) / dt
    accels = torch.cat([accels, accels[..., -1:]], dim=-1)

    def diff_over(v, sv):
        def safe(num, den):
            ok = den.abs() > 1e-12
            return torch.where(ok, num / torch.where(ok, den,
                                                     torch.ones_like(den)),
                               torch.zeros_like(den))

        d0 = safe(v[..., 1] - v[..., 0], sv[..., 1] - sv[..., 0])
        dn = safe(v[..., -1] - v[..., -2], sv[..., -1] - sv[..., -2])
        dm = safe(v[..., 2:] - v[..., :-2], sv[..., 2:] - sv[..., :-2])
        return torch.cat([d0[..., None], dm, dn[..., None]], dim=-1)

    xds = diff_over(xs, s)
    yds = diff_over(ys, s)
    xdds = diff_over(xds, s)
    ydds = diff_over(yds, s)
    kappas = (xds * ydds - yds * xdds) / (
        torch.sqrt(xds * xds + yds * yds) * (xds * xds + yds * yds) + 1e-6)
    return headings, s, speeds, accels, kappas


def _analytic_row_fields(sp: dict, i, fields):
    """Closed-form centerline table row ``i`` from a RoadSpec's tensors
    (``RoadSpec.tensors``): one-hot over the road's segments, elementwise,
    no table lookups."""
    i_e = i[..., None]
    in_seg = (i_e >= sp["row_start"]) & (i_e < sp["row_start"] + sp["count"])
    j = (i_e - sp["row_start"] + 1).to(sp["h"].dtype)
    zero = torch.zeros((), dtype=sp["h"].dtype, device=i.device)

    def sel(v):
        return torch.where(in_seg, v, zero).sum(dim=-1)

    out = {}
    if "x" in fields or "y" in fields:
        ang = sp["ang0"] + (j - 1.0) * sp["dang"]
        if "x" in fields:
            out["x"] = sel(torch.where(
                sp["is_arc"], sp["xc"] + sp["radius"] * torch.cos(ang),
                sp["x0"] + j * sp["stepx"]))
        if "y" in fields:
            out["y"] = sel(torch.where(
                sp["is_arc"], sp["yc"] + sp["radius"] * torch.sin(ang),
                sp["y0"] + j * sp["stepy"]))
    if "theta" in fields:
        out["theta"] = sel(sp["yaw0"] + j * sp["yaw_inc"])
    if "kappa" in fields:
        k = sel(torch.where(in_seg, sp["kappa"], zero))
        out["kappa"] = torch.where(i == 0, sp["kappa0"], k)
    if "left_bound" in fields:
        out["left_bound"] = sp["lb"].expand(i.shape)
    if "right_bound" in fields:
        out["right_bound"] = sp["rb"].expand(i.shape)
    # row 0 is the initial pose (0, 0, theta 0); kappa handled above
    for f in ("x", "y", "theta"):
        if f in out:
            out[f] = torch.where(i == 0, zero, out[f])
    return out


def evaluate_station_fields_analytic(spec, station, fields=DP_FIELDS):
    """evaluate_station_fields against the closed-form RoadSpec instead of
    the sampled table: the same arithmetic index and lerp/slerp between the
    two bracketing rows, the rows computed, not looked up."""
    sp = spec.tensors(station.device)
    h = sp["h"]
    idx = torch.clamp(torch.ceil(station / h).to(torch.int64), 1,
                      spec.n - 1)
    i0 = idx - 1
    i1 = idx
    need = tuple(fields)
    r0 = _analytic_row_fields(sp, i0, need)
    r1 = _analytic_row_fields(sp, i1, need)
    k0 = i0.to(h.dtype) * h
    k1 = i1.to(h.dtype) * h
    denom = k1 - k0
    near = denom.abs() < 1e-10
    w = torch.where(near, torch.zeros_like(denom),
                    (station - k0) / torch.where(near, torch.ones_like(denom),
                                                 denom))
    out = {}
    for f in need:
        if f == "theta":
            out[f] = slerp(r0[f], k0, r1[f], k1,
                           torch.where(near, k0, station))
        else:
            out[f] = (1 - w) * r0[f] + w * r1[f]
    return out
