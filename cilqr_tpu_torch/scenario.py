"""Procedural scenario generation (PyTorch counterpart of
cilqr_tpu/scenario.py): a seeded numpy core, tensors at the boundary.

The numpy core is the JAX package's own, copied (the port imports nothing
of it): the procedural centerline of reference_publisher.py:25-75, random
static vehicles (:116-130), dynamic vehicles (:133-160) and crossing
pedestrians (:163-194), and the 0.1 m road-barrier resampling of
Environment::set_reference (environment.cpp:18-44). The same seed gives the
same scenario, bit for bit, as the JAX package: both draw from
``numpy.random.default_rng(seed)`` in the same order and round the same
float64 arrays to the working type.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .types import Scenario, Traj

# The pedestrian_test road (reference_publisher.py:200-209).
DEFAULT_ROAD = (30.0, (-90.0, 10.0), 10.0, (180.0, 5.0), 36.0,
                (-180.0, 12.0), 50.0)
LEFT_BOUND = 2.5
RIGHT_BOUND = 6.0

# pedestrian_test.launch:2 passes "static pedestrian dynamic":
# 2 static vehicles, 6 pedestrians, 3 dynamic vehicles.
N_STATIC = 2
N_PEDESTRIANS = 6
N_DYNAMIC_VEHICLES = 3

# Padded tensor sizes (slot counts size EXACTLY to the requested obstacle
# counts — every padded slot costs full probe arithmetic in the DP sweep).
MAX_DYNAMIC = N_PEDESTRIANS + N_DYNAMIC_VEHICLES  # exact slot count for the default workload
MAX_DYN_SAMPLES = 256  # >= 161 vehicle samples and >= longest ped crossing


def generate_center_line(road: Sequence = DEFAULT_ROAD, resolution: float = 0.1,
                         left_bound: float = LEFT_BOUND,
                         right_bound: float = RIGHT_BOUND,
                         dtype=np.float64):
    """Centerline arrays (s, x, y, theta, kappa, lb, rb), replicating
    generate_center_line (reference_publisher.py:25-75) including its
    incremental_s-by-resolution bookkeeping."""
    x, y, yaw = 0.0, 0.0, 0.0
    s = 0.0
    rows = [(0.0, x, y, yaw, 0.0)]
    for seg in road:
        if isinstance(seg, (tuple, list)):
            degree, radius = seg
            angle = np.deg2rad(degree)
            arc_dir = -1.0 if angle < 0 else 1.0
            arc_length = angle * radius
            kappa = arc_dir / radius
            start_angle = yaw - np.pi / 2 * arc_dir
            end_angle = start_angle + angle
            center_yaw = yaw + np.pi / 2 * arc_dir
            xc = x + radius * np.cos(center_yaw)
            yc = y + radius * np.sin(center_yaw)
            point_count = int(np.floor(np.abs(arc_length) / resolution))
            angles = np.linspace(start_angle, end_angle, point_count)
            yaw_inc = angle / point_count
            for ang in angles:
                x = xc + radius * np.cos(ang)
                y = yc + radius * np.sin(ang)
                s += resolution
                yaw += yaw_inc
                rows.append((s, x, y, yaw, kappa))
        else:
            for _ in range(int(seg / resolution)):
                x += resolution * np.cos(yaw)
                y += resolution * np.sin(yaw)
                s += resolution
                rows.append((s, x, y, yaw, 0.0))
    arr = np.asarray(rows, dtype)
    if len(arr) > 1:
        arr[0, 4] = arr[1, 4]
    lb = np.full(len(arr), left_bound, dtype)
    rb = np.full(len(arr), right_bound, dtype)
    return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], arr[:, 4], lb, rb


def _frenet_to_cartesian(x, y, theta, lateral):
    return x - lateral * np.sin(theta), y + lateral * np.cos(theta)


def _footprint(x, y, theta, length, width):
    """transform_footprint (reference_publisher.py:84-98); corner order
    matches the reference's (clockwise)."""
    lx = np.array([-length / 2, -length / 2, length / 2, length / 2])
    ly = np.array([-width / 2, width / 2, width / 2, -width / 2])
    c, s = np.cos(theta), np.sin(theta)
    return np.stack([x + c * lx - s * ly, y + s * lx + c * ly], axis=-1)


@dataclasses.dataclass
class CenterlineData:
    s: np.ndarray
    x: np.ndarray
    y: np.ndarray
    theta: np.ndarray
    kappa: np.ndarray
    left_bound: np.ndarray
    right_bound: np.ndarray

    @property
    def n(self):
        return len(self.s)


def make_centerline(road=DEFAULT_ROAD, dtype=np.float64) -> CenterlineData:
    s, x, y, th, k, lb, rb = generate_center_line(road, dtype=dtype)
    return CenterlineData(s, x, y, th, k, lb, rb)


def _random_ref_indices(rng, cl: CenterlineData, count, start_idx=100,
                        back_idx=500):
    return rng.integers(start_idx, cl.n - back_idx, count)


def sample_static_vehicles(rng, cl: CenterlineData, count=N_STATIC,
                           length=4.0, width=2.0):
    """generate_random_vehicles (reference_publisher.py:116-130).
    Returns corners [count, 4, 2]."""
    lateral_samples = np.array([1.0, 0.0, -4.0])
    laterals = lateral_samples[rng.integers(0, 3, count)]
    idx = _random_ref_indices(rng, cl, count)
    theta = cl.theta[idx]
    ox, oy = _frenet_to_cartesian(cl.x[idx], cl.y[idx], theta, laterals)
    return np.stack([_footprint(ox[i], oy[i], theta[i], length, width)
                     for i in range(count)])


def sample_dynamic_vehicles(rng, cl: CenterlineData, count=N_DYNAMIC_VEHICLES,
                            horizon=16.0, dt=0.1):
    """generate_random_dynamic_vehicles (reference_publisher.py:133-160).
    Returns (times [count, L], corners [count, L, 4, 2], lengths [count])."""
    max_s = cl.s[-1]
    idx = _random_ref_indices(rng, cl, count, back_idx=1000)
    velocities = 4.0 + 2.0 * rng.random(count)
    traj_len = int(horizon / dt) + 1
    body = _footprint(0.0, 0.0, 0.0, 4.0, 2.0)  # [4,2] body frame

    times = np.zeros((count, traj_len))
    corners = np.zeros((count, traj_len, 4, 2))
    for i in range(count):
        start_s = cl.s[idx[i]]
        end_ind = np.searchsorted(cl.s, min(max_s, start_s + velocities[i] * horizon),
                                  side="left")
        s_ind = np.linspace(idx[i], end_ind, traj_len).astype(int)
        lateral = 0.0 if rng.random() > 0.5 else -4.0
        tx, ty = _frenet_to_cartesian(cl.x[s_ind], cl.y[s_ind],
                                      cl.theta[s_ind], np.full(traj_len, lateral))
        th = cl.theta[s_ind]
        times[i] = np.arange(traj_len) * dt
        c, s_ = np.cos(th), np.sin(th)
        bx = body[:, 0][None, :]
        by = body[:, 1][None, :]
        corners[i, :, :, 0] = tx[:, None] + c[:, None] * bx - s_[:, None] * by
        corners[i, :, :, 1] = ty[:, None] + s_[:, None] * bx + c[:, None] * by
    lengths = np.full(count, traj_len, np.int32)
    return times, corners, lengths


def sample_pedestrians(rng, cl: CenterlineData, count=N_PEDESTRIANS, dt=0.1,
                       ego_velocity=20.0):
    """generate_random_pedestrian (reference_publisher.py:163-194).
    Returns (times [count, L], corners [count, L, 4, 2], lengths [count])."""
    idx = _random_ref_indices(rng, cl, count)
    velocities = 0.4 + rng.random(count)
    road_lb = -cl.right_bound[0] - 1.0
    road_ub = cl.left_bound[0] + 1.0
    distance = road_ub - road_lb
    body = np.array([[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]])

    lens = (distance / velocities / dt).astype(int)
    L = int(lens.max())
    times = np.zeros((count, L))
    corners = np.zeros((count, L, 4, 2))
    for i in range(count):
        n = lens[i]
        if rng.random() > 0.5:
            laterals = np.linspace(road_ub, road_lb, n)
        else:
            laterals = np.linspace(road_lb, road_ub, n)
        px, py = _frenet_to_cartesian(
            np.full(n, cl.x[idx[i]]), np.full(n, cl.y[idx[i]]),
            np.full(n, cl.theta[idx[i]]), laterals)
        t0 = cl.s[idx[i]] / ego_velocity
        times[i, :n] = t0 + np.arange(n) * dt
        times[i, n:] = times[i, n - 1] if n > 0 else 0.0
        corners[i, :n, :, 0] = px[:, None] + body[None, :, 0]
        corners[i, :n, :, 1] = py[:, None] + body[None, :, 1]
    return times, corners, lens.astype(np.int32)


def build_road_barriers(cl: CenterlineData, step=0.1):
    """Environment::set_reference resampling (environment.cpp:18-44): both
    bounds sampled every 0.1 m; combined set sorted by x; per-side polylines
    kept in station order."""
    n = int((cl.s[-1] - cl.s[0]) / step)
    svals = cl.s[0] + np.arange(n + 1) * step
    ix = np.searchsorted(cl.s, svals, side="left")
    ix = np.clip(ix, 1, cl.n - 1)
    s0 = cl.s[ix - 1]
    s1 = cl.s[ix]
    w = np.where(s1 > s0, (svals - s0) / np.maximum(s1 - s0, 1e-12), 0.0)
    xx = (1 - w) * cl.x[ix - 1] + w * cl.x[ix]
    yy = (1 - w) * cl.y[ix - 1] + w * cl.y[ix]
    # slerp on theta (angles are continuous along this road)
    th = (1 - w) * cl.theta[ix - 1] + w * cl.theta[ix]
    lb = (1 - w) * cl.left_bound[ix - 1] + w * cl.left_bound[ix]
    rb = (1 - w) * cl.right_bound[ix - 1] + w * cl.right_bound[ix]

    lx, ly = _frenet_to_cartesian(xx, yy, th, lb)
    rx, ry = _frenet_to_cartesian(xx, yy, th, -rb)
    left = np.stack([lx, ly], axis=-1)
    right = np.stack([rx, ry], axis=-1)
    both = np.concatenate([
        np.stack([lx, ly], axis=-1).reshape(-1, 2)[:, None, :],
        np.stack([rx, ry], axis=-1).reshape(-1, 2)[:, None, :]], axis=1
    ).reshape(-1, 2)
    both = both[np.argsort(both[:, 0], kind="stable")]
    return both, left, right


def make_scenario_arrays(seed: int, road=DEFAULT_ROAD, n_static=N_STATIC,
                         n_ped=N_PEDESTRIANS, n_dyn_veh=N_DYNAMIC_VEHICLES,
                         cl: CenterlineData | None = None,
                         barriers=None) -> dict:
    """One padded pedestrian_test scenario as float64 numpy arrays (masks
    bool, dyn_len int32), keyed by Scenario field (the centerline by Traj
    field under "centerline"). Pass a precomputed centerline/barriers to
    share the road across a batch."""
    rng = np.random.default_rng(seed)
    if cl is None:
        cl = make_centerline(road)
    if barriers is None:
        barriers = build_road_barriers(cl)
    both, left, right = barriers

    empty_dyn = (np.zeros((0, 1)), np.zeros((0, 1, 4, 2)),
                 np.zeros((0,), np.int32))
    sv = (sample_static_vehicles(rng, cl, n_static) if n_static
          else np.zeros((0, 4, 2)))
    pt, pc, pl = (sample_pedestrians(rng, cl, n_ped) if n_ped else empty_dyn)
    vt, vc, vl = (sample_dynamic_vehicles(rng, cl, n_dyn_veh) if n_dyn_veh
                  else empty_dyn)

    # exactly the requested dynamic and static slot counts (shapes are
    # static per batch)
    n_dyn_slots = max(n_ped + n_dyn_veh, 1)
    dyn_times = np.zeros((n_dyn_slots, MAX_DYN_SAMPLES))
    dyn_obs = np.zeros((n_dyn_slots, MAX_DYN_SAMPLES, 4, 2))
    dyn_len = np.zeros((n_dyn_slots,), np.int32)
    dyn_mask = np.zeros((n_dyn_slots,), bool)

    k = 0
    for times, corners, lens in ((pt, pc, pl), (vt, vc, vl)):
        for i in range(len(lens)):
            L = min(int(lens[i]), MAX_DYN_SAMPLES)
            dyn_times[k, :L] = times[i, :L]
            # pad trailing times with the last sample so searches clamp
            dyn_times[k, L:] = times[i, L - 1] if L > 0 else 0.0
            dyn_obs[k, :L] = corners[i, :L]
            dyn_obs[k, L:] = corners[i, L - 1] if L > 0 else 0.0
            dyn_len[k] = L
            dyn_mask[k] = L > 0
            k += 1

    n_static_slots = max(n_static, 1)
    static_obs = np.zeros((n_static_slots, 4, 2))
    static_mask = np.zeros((n_static_slots,), bool)
    static_obs[:n_static] = sv
    static_mask[:n_static] = True

    z = np.zeros_like(cl.s)
    centerline = dict(time=z, s=cl.s, x=cl.x, y=cl.y, theta=cl.theta,
                      kappa=cl.kappa, velocity=z, left_bound=cl.left_bound,
                      right_bound=cl.right_bound, a=z, jerk=z, delta=z,
                      delta_rate=z)
    return dict(
        centerline=centerline, static_obs=static_obs, static_mask=static_mask,
        dyn_obs=dyn_obs, dyn_times=dyn_times, dyn_mask=dyn_mask,
        dyn_len=dyn_len, barrier_xy=both,
        barrier_mask=np.ones((both.shape[0],), bool),
        left_barrier_xy=left,
        left_barrier_mask=np.ones((left.shape[0],), bool),
        right_barrier_xy=right,
        right_barrier_mask=np.ones((right.shape[0],), bool))


def scenario_from_arrays(arrays: dict, dtype=torch.float32,
                         device="cuda") -> Scenario:
    """Scenario of tensors from make_scenario_arrays' dict (or a stack of
    them): floats rounded to ``dtype`` (as the JAX package rounds its
    float64 arrays), masks bool, dyn_len int32."""

    def conv(a):
        a = np.asarray(a)
        if a.dtype == np.bool_ or a.dtype.kind in "iu":
            return torch.as_tensor(a, device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    fields = {k: conv(v) for k, v in arrays.items() if k != "centerline"}
    cl = Traj(**{k: conv(v) for k, v in arrays["centerline"].items()})
    return Scenario(centerline=cl, **fields)


def make_scenario(seed: int, road=DEFAULT_ROAD, n_static=N_STATIC,
                  n_ped=N_PEDESTRIANS, n_dyn_veh=N_DYNAMIC_VEHICLES,
                  dtype=torch.float32, device="cuda",
                  cl: CenterlineData | None = None,
                  barriers=None) -> Scenario:
    """One padded pedestrian_test scenario (no batch axis), on the card
    unless ``device`` says otherwise."""
    return scenario_from_arrays(make_scenario_arrays(
        seed, road, n_static, n_ped, n_dyn_veh, cl=cl, barriers=barriers),
        dtype, device)


# make_scenario_arrays' road-length arrays and their masks (None: the
# centerline's fields, unmasked)
ROAD_ARRAYS = (("barrier_xy", "barrier_mask"),
               ("left_barrier_xy", "left_barrier_mask"),
               ("right_barrier_xy", "right_barrier_mask"))


def stack_scenario_arrays(rows) -> dict:
    """make_scenario_arrays' dicts stacked over a leading batch axis.
    Scenarios on roads of unequal length are padded to the longest: the
    barrier points and per-side polylines by their last point, masked
    out; the centerline by its last row repeated (a table's own rows are
    reference_line.centerline_rows, and no lookup reads a repeated row).
    Scenarios on one road stack as they are."""
    def edge(a, n):
        a = np.asarray(a)
        return np.concatenate([a, np.repeat(a[-1:], n - len(a), axis=0)])

    def stack(arrs, fill=None):
        n = max(len(a) for a in arrs)
        if fill is None:
            return np.stack([edge(a, n) for a in arrs])
        return np.stack([np.concatenate([a, np.full(n - len(a), fill)])
                         for a in arrs])

    road = {k for pair in ROAD_ARRAYS for k in pair}
    out = {k: np.stack([r[k] for r in rows]) for k in rows[0]
           if k != "centerline" and k not in road}
    for pts, mask in ROAD_ARRAYS:
        out[pts] = stack([r[pts] for r in rows])
        out[mask] = stack([r[mask] for r in rows], False)
    out["centerline"] = {k: stack([r["centerline"][k] for r in rows])
                         for k in rows[0]["centerline"]}
    return out


def make_scenario_batch(seeds, dtype=torch.float32, device="cuda",
                        **kw) -> Scenario:
    """Scenarios stacked over a leading batch axis (one road shared), on
    the card unless ``device`` says otherwise. Scenarios on roads of their
    own: stack_scenario_arrays of their make_scenario_arrays, then
    scenario_from_arrays."""
    cl = make_centerline(kw.pop("road", DEFAULT_ROAD))
    barriers = build_road_barriers(cl)
    rows = [make_scenario_arrays(int(s), cl=cl, barriers=barriers, **kw)
            for s in seeds]
    return scenario_from_arrays(stack_scenario_arrays(rows), dtype, device)


@dataclasses.dataclass
class RoadSpec:
    """Closed-form per-row description of the generated centerline table
    (cilqr_tpu/scenario.py RoadSpec): arc rows are xc + R*cos(ang0 +
    (j-1)*dang) with theta accumulated in steps of yaw_inc, straight rows
    step (dx, dy) per row, so every row is reproducible from ~12 scalars a
    segment. The DP evaluates station fields from it with no table lookups
    (reference_line.evaluate_station_fields_analytic) and tests the road
    barrier against its finite segments (world.barrier_hit_road_spec).

    Fields are numpy arrays [NSEG] in the spec's type (``h``, ``lb``,
    ``rb``, ``kappa0`` 0-d); ``n`` is the table's row count.
    ``tensors(device)`` gives them as tensors on a device (built once per
    device)."""

    row_start: np.ndarray
    count: np.ndarray
    is_arc: np.ndarray
    xc: np.ndarray
    yc: np.ndarray
    radius: np.ndarray
    ang0: np.ndarray
    dang: np.ndarray
    yaw0: np.ndarray
    yaw_inc: np.ndarray
    kappa: np.ndarray
    x0: np.ndarray
    y0: np.ndarray
    stepx: np.ndarray
    stepy: np.ndarray
    h: np.ndarray
    n: int
    lb: np.ndarray
    rb: np.ndarray
    kappa0: np.ndarray
    _on: dict = dataclasses.field(default_factory=dict, repr=False,
                                  compare=False)

    def tensors(self, device) -> dict:
        """The spec's arrays as tensors on ``device`` (ints int32 -> int64
        for indexing arithmetic, bools bool, floats in the spec's type)."""
        key = str(torch.device(device))
        if key not in self._on:
            out = {}
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if isinstance(v, np.ndarray):
                    out[f.name] = torch.as_tensor(v, device=device)
            self._on[key] = out
        return self._on[key]


def analytic_road_spec(road: Sequence = DEFAULT_ROAD, resolution: float = 0.1,
                       left_bound: float = LEFT_BOUND,
                       right_bound: float = RIGHT_BOUND,
                       dtype=np.float64) -> RoadSpec:
    """The RoadSpec mirroring generate_center_line's bookkeeping
    (reference_publisher.py:25-75): same linspace angles, same
    yaw_inc = angle/point_count accumulation, same floor row counts.
    ``dtype`` is a numpy float type."""
    x, y, yaw = 0.0, 0.0, 0.0
    row = 1
    segs = []
    for seg in road:
        if isinstance(seg, (tuple, list)):
            degree, radius = seg
            angle = np.deg2rad(degree)
            arc_dir = -1.0 if angle < 0 else 1.0
            arc_length = angle * radius
            kappa = arc_dir / radius
            start_angle = yaw - np.pi / 2 * arc_dir
            end_angle = start_angle + angle
            center_yaw = yaw + np.pi / 2 * arc_dir
            xc = x + radius * np.cos(center_yaw)
            yc = y + radius * np.sin(center_yaw)
            pc = int(np.floor(np.abs(arc_length) / resolution))
            if pc < 2:
                raise ValueError(
                    f"arc segment {seg} yields {pc} centerline rows "
                    f"(< 2 at resolution {resolution}); analytic_road_spec "
                    "requires arcs spanning at least 2 rows")
            segs.append(dict(row_start=row, count=pc, is_arc=True, xc=xc,
                             yc=yc, radius=radius, ang0=start_angle,
                             dang=angle / (pc - 1), yaw0=yaw,
                             yaw_inc=angle / pc, kappa=kappa, x0=x, y0=y,
                             stepx=0.0, stepy=0.0))
            x = xc + radius * np.cos(end_angle)
            y = yc + radius * np.sin(end_angle)
            yaw += pc * (angle / pc)
            row += pc
        else:
            nrow = int(seg / resolution)
            segs.append(dict(row_start=row, count=nrow, is_arc=False,
                             xc=0.0, yc=0.0, radius=0.0, ang0=0.0, dang=0.0,
                             yaw0=yaw, yaw_inc=0.0, kappa=0.0, x0=x, y0=y,
                             stepx=resolution * np.cos(yaw),
                             stepy=resolution * np.sin(yaw)))
            x += nrow * resolution * np.cos(yaw)
            y += nrow * resolution * np.sin(yaw)
            row += nrow

    def col(k, dt=dtype):
        return np.asarray(np.asarray([s[k] for s in segs]), dt)

    return RoadSpec(
        row_start=col("row_start", np.int32), count=col("count", np.int32),
        is_arc=np.asarray([s["is_arc"] for s in segs]),
        xc=col("xc"), yc=col("yc"), radius=col("radius"), ang0=col("ang0"),
        dang=col("dang"), yaw0=col("yaw0"), yaw_inc=col("yaw_inc"),
        kappa=col("kappa"), x0=col("x0"), y0=col("y0"), stepx=col("stepx"),
        stepy=col("stepy"), h=np.asarray(resolution, dtype), n=row,
        lb=np.asarray(left_bound, dtype), rb=np.asarray(right_bound, dtype),
        kappa0=np.asarray(segs[0]["kappa"], dtype))
