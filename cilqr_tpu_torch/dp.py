"""Spatio-temporal DP coarse planner (PyTorch counterpart of
cilqr_tpu/dp.py), batched over scenarios.

DpPlanner (dp_planner.{h,cpp}): an NT=5 x NS=7 x NL=10 grid search. Each
layer transition is one [70 parents x 70 children x 16 interpolation
points] cost tensor per scenario, its collision probes batched through
world.py, then an argmin over parents that keeps parent indices. The DP is
non-Markov as the reference is: a transition's cost depends on the parent
cell's accumulated station and on the grandparent through the stored
parent indices (dp_planner.cpp:39-54,87-103).

Where the JAX package vmaps one scenario's plan, every tensor here carries
the scenario axis first. Two paths run the layer sweep:

- the kernel path (``_plan_sweep``), on the card for the road tests the
  replans run (kernels/dpsweep.py: ``takes_kernel``): the first layer and
  every transition of the whole batch in one launch of the hand-written
  kernel csrc/dpsweep.cu, its inputs prepared once a plan;
- the plain path (``_plan_chunk``), everywhere else (CPU tensors, exact
  mode, frenet mode without a RoadSpec, a grid without the probe's dilated
  table): broadcast tensors, scenarios in chunks so that a layer's probes
  fit a budget (``PROBES_PER_CHUNK``), all parents of a chunk at once
  (``DpConfig.parent_chunk`` = 70, the layer's full width).

The two agree bit for bit on the card; the traceback (``_trace_back``) is
theirs in common.

The road barrier is probed by ``DpConfig.collision_mode`` (world.py):
"frenet" (the RoadSpec's finite test, or without a spec the station-field
stand-in), "grid" (the road's BarrierGrid) or "exact" (every barrier
point, its temporaries bounded by world.EXACT_TESTS_PER_CHUNK).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import PlannerConfig
from .kernels import dpsweep
from .reference_line import (DP_FIELDS, compute_path_profile,
                             evaluate_station_fields,
                             evaluate_station_fields_analytic,
                             get_projection, pack_station_rows)
from .profiling import count, host, span, spanned, upload
from .types import Scenario, Traj
from .world import (LaneGrid, check_optimization_collision, dilate_polys,
                    dyn_polys_at)

K_EPS_LOCAL = 1e-3   # dp_planner.cpp:29 (file-local kMathEpsilon)

# probes of one layer's collision sweep held at once on the plain path
# (scenarios x parents x children x interpolation points); about 3 GB of
# temporaries in float32. The kernel path holds no probe temporaries.
PROBES_PER_CHUNK = 1 << 23


class DpResult(NamedTuple):
    traj: Traj               # [B, 81] coarse trajectory
    ok: torch.Tensor         # [B] bool: min_cost < w_obstacle
    min_cost: torch.Tensor   # [B]
    sel_s: torch.Tensor      # [B, NT] winning station indices (traceback)
    sel_l: torch.Tensor      # [B, NT] winning lateral indices


def _lateral_offset(cl: Traj, s, l_ind, safe_margin, nl, packed=None,
                    rows=None):
    """GetLateralOffset (dp_planner.h:84-92): l_ind == NL-1 -> centerline;
    else lb + (ub-lb) * linspace(0,1,NL-1)[l_ind], from the table."""
    ref = evaluate_station_fields(cl, s, ("left_bound", "right_bound"),
                                  packed=packed, rows=rows)
    lb = -ref["right_bound"] + safe_margin
    ub = ref["left_bound"] - safe_margin
    frac = l_ind.to(s.dtype) / (nl - 2)
    off = lb + (ub - lb) * frac
    return torch.where(l_ind == nl - 1, torch.zeros_like(off), off)


def _interp_sl(parent_s, parent_l, station, cur_l, nseg):
    """InterpolateLinearly (dp_planner.cpp:283-320): nseg points from the
    parent (the child endpoint excluded). Returns (s, l) [..., nseg]."""
    i = torch.arange(nseg, dtype=parent_s.dtype, device=parent_s.device)
    s_step = station / nseg
    l_step = (cur_l - parent_l) / nseg
    s = parent_s[..., None] + i * s_step[..., None]
    l = parent_l[..., None] + i * l_step[..., None]
    return s, l


def _align(d, nq):
    """DilatedPolys fields [b, ...] with nq singleton axes after the batch
    axis, to broadcast against probes [b, *q] with a trailing poly axis."""
    return d.map(lambda t: t.reshape(t.shape[:1] + (1,) * nq + t.shape[1:]))


def _segment_cost(scn: Scenario, grid, cfg: PlannerConfig, s_pts, l_pts,
                  last_s, last_l, ref, safe_margin, dilated, spec):
    """Collision / bounds sweep over interpolated (s, l) segments
    (GetCollisionCost, dp_planner.cpp:39-85): s_pts, l_pts [b, ..., nseg];
    ``ref`` the station fields at s_pts (broadcasting over the child
    laterals); ``dilated`` the static and dynamic obstacles dilated by the
    probe half-size, aligned to the probes. Returns the obstacle cost (0
    or w_obstacle) [b, ...]."""
    dp = cfg.dp
    veh = cfg.vehicle
    prev_s = torch.cat([last_s[..., None], s_pts[..., :-1]], dim=-1)
    prev_l = torch.cat([last_l[..., None], l_pts[..., :-1]], dim=-1)
    dl = l_pts - prev_l
    ds = torch.clamp(s_pts - prev_s, min=K_EPS_LOCAL)

    cx = ref["x"] - l_pts * torch.sin(ref["theta"])
    cy = ref["y"] + l_pts * torch.cos(ref["theta"])
    lb = torch.clamp(-ref["right_bound"] + safe_margin, max=0.0)
    ub = torch.clamp(ref["left_bound"] - safe_margin, min=0.0)
    off_road = (l_pts < lb - K_EPS_LOCAL) | (l_pts > ub + K_EPS_LOCAL)
    heading = ref["theta"] + torch.atan(
        (dl / ds) / (1.0 - ref["kappa"] * l_pts))

    mode = dp.collision_mode
    frenet = None
    if mode == "frenet" and spec is None:
        # the station-field stand-in, from the fields already evaluated at
        # the probe stations (broadcasting over the child laterals)
        frenet = (ref["x"], ref["y"], ref["theta"], ref["kappa"],
                  ref["left_bound"], ref["right_bound"])
    collide = check_optimization_collision(
        scn, cx, cy, heading, veh.radius, veh.r2x, veh.f2x,
        collision_buffer=0.0, mode=mode, dilated=dilated,
        road_spec=spec if mode == "frenet" else None, grid=grid,
        frenet=frenet)
    any_bad = (off_road | collide).any(dim=-1)
    w = torch.full(any_bad.shape, dp.w_obstacle, dtype=s_pts.dtype,
                   device=s_pts.device)
    return torch.where(any_bad, w, torch.zeros_like(w))


def _check_spec(spec, cl: Traj, packed):
    """The spec must describe these scenarios' road: a mismatched spec
    silently yields wrong DP decisions. Rows counted, and 5 stations of
    every scenario's table spot-checked (two host reads, one upload)."""
    if int(spec.n) != int(cl.s.shape[-1]):
        raise ValueError(
            f"RoadSpec.n={int(spec.n)} != centerline rows "
            f"{int(cl.s.shape[-1])}: spec built for a different road")
    s_last = host(cl.s[:, -1]).double().numpy()
    probe = np.linspace(np.zeros_like(s_last), s_last, 7, axis=-1)[:, 1:-1]
    probe_s = upload(probe, dtype=cl.s.dtype, device=cl.s.device)
    ref_a = evaluate_station_fields_analytic(spec, probe_s, ("x", "y"))
    ref_t = evaluate_station_fields(cl, probe_s, ("x", "y"), packed=packed)
    err = float(host(torch.maximum((ref_a["x"] - ref_t["x"]).abs().max(),
                                   (ref_a["y"] - ref_t["y"]).abs().max())))
    if err > 1e-3:
        raise ValueError(
            f"RoadSpec disagrees with scenario centerline by {err:.3g} m at "
            f"spot stations: spec/road mismatch")


@spanned("dp")
def plan(scns: Scenario, start_x, start_y, start_theta, cfg: PlannerConfig,
         grid=None, spec=None, rows=None) -> DpResult:
    """DpPlanner::Plan (dp_planner.cpp:135-281) for a batch of scenarios
    (leading axis B) and start poses [B].

    grid: the road's world.BarrierGrid, required in ``collision_mode``
    "grid" (built with ``half`` = the vehicle radius, the probes take its
    one-gather dilated table), or where each scenario is on its own road a
    world.LaneGrid (each probe reads its scenario's table); ignored in the
    other modes.

    rows [B]: each scenario's centerline row count where the scenarios'
    tables are padded to one length (roads of unequal length;
    reference_line.centerline_rows), None = every row. A RoadSpec
    describes one road, and takes no rows.

    spec: the road's scenario.RoadSpec (the path bench.py runs): every
    station lookup of the decision path is closed-form
    (evaluate_station_fields_analytic) and frenet-mode road-barrier probes
    take the finite per-segment test (world.barrier_hit_road_spec);
    without it the lookups read the centerline table and frenet mode takes
    the station-field stand-in (world.barrier_hit_frenet). The traceback
    and the 81-knot output stay on the table."""
    if cfg.dp.collision_mode == "grid" and grid is None:
        raise ValueError("DP collision mode 'grid' needs the road's "
                         "BarrierGrid (world.build_barrier_grid)")
    if spec is not None and rows is not None:
        raise ValueError("a RoadSpec describes one road: scenarios on roads "
                         "of their own (rows) take none")
    s = scns.centerline.s
    if dpsweep.takes_kernel(s.device, s.dtype, cfg, grid, spec):
        return _plan_sweep(scns, start_x, start_y, cfg, grid, spec, rows)
    return _plan_plain(scns, start_x, start_y, start_theta, cfg, grid, spec,
                       rows)


def _plan_plain(scns: Scenario, start_x, start_y, start_theta,
                cfg: PlannerConfig, grid, spec, rows=None) -> DpResult:
    """plan's plain path: the batch in chunks of scenarios whose probes
    fit PROBES_PER_CHUNK."""
    B = scns.static_obs.shape[0]
    dp = cfg.dp
    P = dp.ns * dp.nl
    width = min(max(1, dp.parent_chunk), P)
    per_scn = width * P * 16
    chunk = max(1, PROBES_PER_CHUNK // per_scn)
    if chunk >= B:
        return _plan_chunk(scns, start_x, start_y, start_theta, cfg, grid,
                           spec, rows)

    def part(i):
        sl = slice(i, i + chunk)
        return _plan_chunk(
            scns.map(lambda a: a[sl]), start_x[sl], start_y[sl],
            start_theta[sl], cfg,
            grid.take(sl) if isinstance(grid, LaneGrid) else grid, spec,
            None if rows is None else rows[sl])

    parts = [part(i) for i in range(0, B, chunk)]
    return DpResult(
        traj=parts[0].traj.map(lambda *v: torch.cat(v),
                               *(p.traj for p in parts[1:])),
        **{f: torch.cat([getattr(p, f) for p in parts])
           for f in ("ok", "min_cost", "sel_s", "sel_l")})


@spanned("dp.chunk")
def _plan_chunk(scn: Scenario, start_x, start_y, start_theta,
                cfg: PlannerConfig, grid, spec, rows=None) -> DpResult:
    dp = cfg.dp
    NT, NS, NL = dp.nt, dp.ns, dp.nl
    cl = scn.centerline
    dtype, dev = cl.s.dtype, cl.s.device
    b = cl.s.shape[0]
    unit_time = cfg.tf / NT
    probe_times = _probe_times(cfg, dtype, dev)
    station = (unit_time * cfg.vehicle.max_velocity) * torch.arange(
        NS, dtype=dtype, device=dev) / (NS - 1)
    safe_margin = cfg.vehicle.width / 2 * 1.5  # dp_planner.cpp:36
    radius = cfg.vehicle.radius

    s0, l0, _ = get_projection(cl, start_x.to(dtype), start_y.to(dtype))

    packed = pack_station_rows(cl)
    sd = dilate_polys(scn.static_obs, scn.static_mask[..., None], radius,
                      rect=True)
    l_inds = torch.arange(NL, device=dev)

    if spec is not None:
        _check_spec(spec, cl, packed)

        def eval_f(sv, fields=DP_FIELDS):
            return evaluate_station_fields_analytic(spec, sv, fields)
    else:
        def eval_f(sv, fields=DP_FIELDS):
            return evaluate_station_fields(cl, sv, fields, packed=packed,
                                           rows=rows)

    def lat_off(s, li):
        ref = eval_f(s, ("left_bound", "right_bound"))
        lb = -ref["right_bound"] + safe_margin
        ub = ref["left_bound"] - safe_margin
        frac = li.to(s.dtype) / (NL - 2)
        off = lb + (ub - lb) * frac
        return torch.where(li == NL - 1, torch.zeros_like(off), off)

    def offsets(svals):
        """[b, ...] stations -> [b, ..., NL] lateral offsets, one lookup
        per station for all NL laterals."""
        ref = eval_f(svals, ("left_bound", "right_bound"))
        lb = -ref["right_bound"] + safe_margin
        ub = ref["left_bound"] - safe_margin
        frac = l_inds.to(svals.dtype) / (NL - 2)
        off = lb[..., None] + (ub - lb)[..., None] * frac
        return torch.where(l_inds == NL - 1, torch.zeros_like(off), off)

    def dyn_dilated(tv):
        polys, active = dyn_polys_at(scn, tv)
        return dilate_polys(polys, active[..., None], radius, rect=True)

    count("dp.chunks", 1)
    with span("dp.layers"):
        # ---- first layer (dp_planner.cpp:153-159): parent = start pseudo-cell
        nseg0 = 17  # dp_planner.cpp:288-292 with t_ind 0
        cur_s_l0 = s0[:, None] + station                          # [b, NS]
        cur_l_l0 = offsets(cur_s_l0)                              # [b, NS, NL]
        ps = s0[:, None, None].expand(b, NS, NL)
        pl = l0[:, None, None].expand(b, NS, NL)
        st_nl = station[:, None].expand(NS, NL)
        s_pts, l_pts = _interp_sl(ps, pl, st_nl, cur_l_l0,
                                  nseg0)                  # [b, NS, NL, 17]
        tv0 = probe_times[:nseg0]
        s_dd0, _ = _interp_sl(ps[..., :1], pl[..., :1], station[:, None],
                              cur_l_l0[..., :1], nseg0)       # [b, NS, 1, 17]
        obst0 = _segment_cost(scn, grid, cfg, s_pts, l_pts, ps, pl,
                              eval_f(s_dd0), safe_margin,
                              (_align(sd, 3), _align(dyn_dilated(tv0), 2)),
                              spec)

        cur_l = cur_l_l0
        ds1 = st_nl
        dl1 = cur_l - l0[:, None, None]
        cost_lat = cur_l.abs()
        cost_lat_chg = (l0[:, None, None] - cur_l).abs() / (ds1 + K_EPS_LOCAL)
        cost_lat_chg_t = (dl1 - 0.0).abs() / unit_time
        cost_v = (ds1 / unit_time - dp.nominal_velocity).abs()
        cost_v_chg = (ds1 - 0.0).abs() / unit_time
        delta0 = (dp.w_lateral * cost_lat + dp.w_lateral_change * cost_lat_chg
                  + dp.w_lateral_velocity_change * cost_lat_chg_t
                  + dp.w_longitudinal_velocity_bias * cost_v
                  + dp.w_longitudinal_velocity_change * cost_v_chg)
        layer_cost = torch.where(obst0 >= dp.w_obstacle,
                                 torch.full_like(delta0, dp.w_obstacle),
                                 delta0)

        costs = [layer_cost]                                      # [b, NS, NL]
        cur_ss = [cur_s_l0[:, :, None].expand(b, NS, NL)]
        minus1 = torch.full((b, NS, NL), -1, dtype=torch.int64, device=dev)
        parent_s_inds = [minus1]
        parent_l_inds = [minus1]

        nseg = 16  # layers >= 1 (dp_planner.cpp:293-296)
        P = NS * NL
        Cn = NS * NL
        c_station = station.repeat_interleave(NL)                 # [C]
        p_l_ind_self = l_inds.repeat(NS).expand(b, P)
        p_own_sind = torch.arange(NS, device=dev).repeat_interleave(NL)
        width = max(1, min(dp.parent_chunk, P))

        for t in range(NT - 1):
            p_cost = costs[t].reshape(b, P)
            p_s = cur_ss[t].reshape(b, P)
            p_sind = parent_s_inds[t].reshape(b, P)
            p_lind = parent_l_inds[t].reshape(b, P)
            p_l = lat_off(p_s, p_l_ind_self)

            # grandparents (dp_planner.cpp:42-53,92-103)
            if t == 0:
                gp_s = s0[:, None].expand(b, P)
                gp_l = l0[:, None].expand(b, P)
            else:
                prev_flat = cur_ss[t - 1].reshape(b, P)
                gflat = (torch.clamp(p_sind, min=0) * NL
                         + torch.clamp(p_lind, min=0))
                gp_s = torch.gather(prev_flat, 1, gflat)
                gp_l = lat_off(gp_s, p_lind)

            # the previous segment's last point (GetCollisionCost:51-53)
            st = station[p_own_sind]
            sp, lp = _interp_sl(gp_s, gp_l, st, p_l, 17 if t == 0 else nseg)
            last_s = sp[..., -1]
            last_l = lp[..., -1]

            cur_s_c = p_s[:, :, None] + c_station                 # [b, P, C]
            cur_s_m = p_s[:, :, None] + station                   # [b, P, NS]
            cur_l_c = offsets(cur_s_m.reshape(b, -1)).reshape(b, P, Cn)

            tv = probe_times[nseg0 + nseg * t:nseg0 + nseg * (t + 1)]
            dilated = (_align(sd, 4), _align(dyn_dilated(tv), 3))
            st_c = station[:, None].expand(NS, NL)
            obst = []
            for p0 in range(0, P, width):
                sl = slice(p0, min(P, p0 + width))
                w = sl.stop - sl.start
                cp_s = p_s[:, sl, None, None]
                cp_l = p_l[:, sl, None, None]
                ccur_l = cur_l_c[:, sl].reshape(b, w, NS, NL)
                csp, clp = _interp_sl(cp_s.expand(b, w, NS, NL),
                                      cp_l.expand(b, w, NS, NL), st_c, ccur_l,
                                      nseg)               # [b, w, NS, NL, 16]
                s_dd, _ = _interp_sl(cp_s.expand(b, w, NS, 1),
                                     cp_l.expand(b, w, NS, 1), st_c[:, :1],
                                     ccur_l[..., :1], nseg)
                obst.append(_segment_cost(
                    scn, grid, cfg, csp, clp,
                    last_s[:, sl, None, None].expand(b, w, NS, NL),
                    last_l[:, sl, None, None].expand(b, w, NS, NL),
                    eval_f(s_dd), safe_margin, dilated,
                    spec).reshape(b, w, Cn))
            obst = torch.cat(obst, dim=1)                         # [b, P, C]

            ds1 = c_station
            dl1 = cur_l_c - p_l[:, :, None]
            ds0 = p_s[:, :, None] - gp_s[:, :, None]
            dl0 = p_l[:, :, None] - gp_l[:, :, None]
            cost_lat = cur_l_c.abs()
            cost_lat_chg = (p_l[:, :, None] - cur_l_c).abs() / (
                ds1 + K_EPS_LOCAL)
            cost_lat_chg_t = (dl1 - dl0).abs() / unit_time
            cost_v = (ds1 / unit_time - dp.nominal_velocity).abs()
            cost_v_chg = ((ds1 - ds0) / unit_time).abs()
            delta = (dp.w_lateral * cost_lat
                     + dp.w_lateral_change * cost_lat_chg
                     + dp.w_lateral_velocity_change * cost_lat_chg_t
                     + dp.w_longitudinal_velocity_bias * cost_v
                     + dp.w_longitudinal_velocity_change * cost_v_chg)
            delta = torch.where(obst >= dp.w_obstacle,
                                torch.full_like(delta, dp.w_obstacle), delta)

            total = p_cost[:, :, None] + delta                    # [b, P, C]
            best_p = torch.argmin(total, dim=1)               # [b, C], first
            best_cost = torch.gather(total, 1, best_p[:, None])[:, 0]
            new_cur_s = torch.gather(cur_s_c, 1, best_p[:, None])[:, 0]
            costs.append(best_cost.reshape(b, NS, NL))
            cur_ss.append(new_cur_s.reshape(b, NS, NL))
            parent_s_inds.append((best_p // NL).reshape(b, NS, NL))
            parent_l_inds.append((best_p % NL).reshape(b, NS, NL))

    with span("dp.trace_back"):
        return _trace_back(cfg, cl, packed, s0, l0, station, costs, cur_ss,
                           parent_s_inds, parent_l_inds, rows)


def _probe_times(cfg: PlannerConfig, dtype, dev):
    """Every layer's probe times in one tensor [17 + 16 (NT-1)]: the first
    layer's 17 from 0, then each transition's 16 from its start time (both
    paths slice their layers' times from it)."""
    NT = cfg.dp.nt
    unit_time = cfg.tf / NT
    times = unit_time + (cfg.tf - unit_time) * torch.arange(
        NT, dtype=dtype, device=dev) / (NT - 1)
    tv = [torch.arange(17, dtype=dtype, device=dev) * (unit_time / 17)]
    tv += [times[t] + torch.arange(16, dtype=dtype, device=dev) * (
        unit_time / 16) for t in range(NT - 1)]
    return torch.cat(tv)


def _sweep_slabs(scn: Scenario, cfg: PlannerConfig, dtype, dev):
    """The kernel's obstacles: the static ones dilated by the vehicle
    radius [B, KS, SLAB], and the dynamic ones at every layer's probe times
    [B, 17 + 16 (NT-1), KD, SLAB], one dyn_polys_at and one dilate_polys
    call over the concatenated times."""
    radius = cfg.vehicle.radius
    sd = dilate_polys(scn.static_obs, scn.static_mask[..., None], radius,
                      rect=True)
    polys, active = dyn_polys_at(scn, _probe_times(cfg, dtype, dev))
    dd = dilate_polys(polys, active[..., None], radius, rect=True)
    return dpsweep.pack_slabs(sd), dpsweep.pack_slabs(dd)


def _plan_sweep(scns: Scenario, start_x, start_y, cfg: PlannerConfig, grid,
                spec, rows=None) -> DpResult:
    """plan's kernel path: the projection, the packed station rows, the
    spec check and the obstacles' slabs once for the batch, then the layer
    sweep of every scenario in one launch (kernels/dpsweep.py), then the
    traceback."""
    dp = cfg.dp
    NT, NS, NL = dp.nt, dp.ns, dp.nl
    cl = scns.centerline
    dtype, dev = cl.s.dtype, cl.s.device
    B = cl.s.shape[0]
    unit_time = cfg.tf / NT
    station = (unit_time * cfg.vehicle.max_velocity) * torch.arange(
        NS, dtype=dtype, device=dev) / (NS - 1)
    with span("dp.layers"):
        s0, l0, _ = get_projection(cl, start_x.to(dtype), start_y.to(dtype))
        s0, l0 = s0.contiguous(), l0.contiguous()
        packed = pack_station_rows(cl)
        if spec is not None:
            _check_spec(spec, cl, packed)
        sslab, dslab = _sweep_slabs(scns, cfg, dtype, dev)
        with span("dp.sweep"):
            cost, cur_s, ps_ind, pl_ind = dpsweep.dp_sweep(
                cfg, s0, l0, station, sslab, dslab, packed=packed, grid=grid,
                spec=spec, rows=rows)

    def layers(v):
        return [v[t].reshape(B, NS, NL) for t in range(NT)]

    with span("dp.trace_back"):
        return _trace_back(cfg, cl, packed, s0, l0, station, layers(cost),
                           layers(cur_s), layers(ps_ind), layers(pl_ind),
                           rows)


def _trace_back(cfg: PlannerConfig, cl: Traj, packed, s0, l0, station,
                costs, cur_ss, parent_s_inds, parent_l_inds,
                rows=None) -> DpResult:
    """The winning path from the layers' costs, accumulated stations and
    parent indices (lists of NT [b, NS, NL] tensors), interpolated to 81
    knots on the centerline table, with its profile."""
    dp = cfg.dp
    NT, NL = dp.nt, dp.nl
    P = dp.ns * NL
    dtype, dev = cl.s.dtype, cl.s.device
    b = cl.s.shape[0]
    safe_margin = cfg.vehicle.width / 2 * 1.5  # dp_planner.cpp:36
    # ---- trace back (dp_planner.cpp:184-206)
    final = costs[NT - 1].reshape(b, P)
    best = torch.argmin(final, dim=1)
    min_cost = torch.gather(final, 1, best[:, None])[:, 0]

    def cell(table, si, li):
        return torch.gather(table.reshape(b, P), 1,
                            (si * NL + li)[:, None])[:, 0]

    sel_s = [None] * NT
    sel_l = [None] * NT
    si = best // NL
    li = best % NL
    for i in range(NT - 1, -1, -1):
        sel_s[i] = si
        sel_l[i] = li
        if i:
            si, li = (cell(parent_s_inds[i], si, li),
                      cell(parent_l_inds[i], si, li))

    # ---- interpolate the winning path to 81 knots
    # (dp_planner.cpp:214-245)
    all_s = []
    all_l = []
    for i in range(NT):
        if i == 0:
            p_s_i = s0
            p_l_i = l0
            nseg_i = 17
        else:
            p_s_i = cell(cur_ss[i - 1], sel_s[i - 1], sel_l[i - 1])
            p_l_i = _lateral_offset(cl, p_s_i, sel_l[i - 1],
                                    safe_margin, NL, packed, rows)
            nseg_i = 16
        st_i = station[sel_s[i]]
        cur_s_i = p_s_i + st_i
        cur_l_i = _lateral_offset(cl, cur_s_i, sel_l[i], safe_margin, NL,
                                  packed, rows)
        sseg, lseg = _interp_sl(p_s_i, p_l_i, st_i, cur_l_i, nseg_i)
        all_s.append(sseg)
        all_l.append(lseg)
    seg_s = torch.cat(all_s, dim=-1)   # [b, 81]
    seg_l = torch.cat(all_l, dim=-1)

    prev_s = torch.cat([s0[:, None], seg_s[:, :-1]], dim=-1)
    prev_l = torch.cat([l0[:, None], seg_l[:, :-1]], dim=-1)
    dl = seg_l - prev_l
    ds = torch.clamp(seg_s - prev_s, min=K_EPS_LOCAL)
    ref = evaluate_station_fields(cl, seg_s, packed=packed, rows=rows)
    cx = ref["x"] - seg_l * torch.sin(ref["theta"])
    cy = ref["y"] + seg_l * torch.cos(ref["theta"])
    theta = ref["theta"] + torch.atan((dl / ds)
                                      / (1.0 - ref["kappa"] * seg_l))

    # ---- profile (dp_planner.cpp:246-276)
    _, _, speeds, accels, kappas = compute_path_profile(cfg.delta_t, cx,
                                                        cy)
    n = seg_s.shape[-1]
    tt = (cfg.delta_t * torch.arange(n, dtype=dtype,
                                     device=dev)).expand(b, n)
    zeros = torch.zeros_like(seg_s)
    traj = Traj(time=tt, s=seg_s, x=cx, y=cy, theta=theta, kappa=kappas,
                velocity=speeds, left_bound=ref["left_bound"],
                right_bound=ref["right_bound"], a=accels, jerk=zeros,
                delta=torch.atan(kappas * cfg.vehicle.wheel_base),
                delta_rate=zeros)
    return DpResult(traj=traj, ok=min_cost < dp.w_obstacle,
                    min_cost=min_cost, sel_s=torch.stack(sel_s, dim=-1),
                    sel_l=torch.stack(sel_l, dim=-1))
