"""Traffic of kind "replan": full replans of the whole batch, back to back
from one caller (a closed loop). Call k replans every lane of the batch
through ``pipeline.plan_batch`` from the configuration's start moved by
row k of the seed's perturbations."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, inputs
from portbench.ref import scenario as ref_scenario
from portbench.ref import stages as ref_stages

PERTURBATION_ROWS = 256   # calls before the perturbations repeat
SAMPLE_CALLS = 2          # the compared call is one of the first two


def _np_dtype(config):
    return {"float32": np.float32, "float64": np.float64}[config["dtype"]]


def _torch_dtype(config):
    return {"float32": torch.float32, "float64": torch.float64}[
        config["dtype"]]


def program_setup(cell, seed, device, log, arrays=None):
    """The program's set-up from the benchmark's inputs: its config, the
    scenarios on the device, the road's lane constraints, RoadSpec and (in
    grid mode) BarrierGrid, built by the program's own functions."""
    import cilqr_tpu_torch as P
    from cilqr_tpu_torch import config as P_config
    from cilqr_tpu_torch import pipeline, scenario

    conf, traffic = cell.config, cell.traffic
    B = traffic["batch"]
    t = time.perf_counter()
    fixed = traffic.get("fixed_scenarios", False)
    if arrays is None:
        arrays = inputs.scenario_arrays(conf, seed, B, fixed)
    dy = inputs.perturbations(seed, PERTURBATION_ROWS, B,
                              traffic["perturb_y"], fixed)
    log(f"set-up: {B} scenarios and {PERTURBATION_ROWS} rows of start "
        f"perturbations generated in {time.perf_counter() - t:.3f} s")
    dtype, np_dt = _torch_dtype(conf), _np_dtype(conf)
    cfg = P_config.from_dict(inputs.planner(conf))
    scns = scenario.scenario_from_arrays(arrays, dtype=dtype, device=device)
    left, right = inputs.road_arrays(conf)
    lane = pipeline.make_lane_tuple(left, right, cfg, np_dt)
    spec = scenario.analytic_road_spec(dtype=np_dt) if conf["road_spec"] \
        else None
    grid = (pipeline.road_grid(scns.barrier_xy[0], cfg)
            if cfg.dp.collision_mode == "grid" else None)
    starts = torch.as_tensor(
        np.stack([inputs.starts(conf, row) for row in dy]), dtype=dtype,
        device=device)                                   # [rows, B, 4]
    return dict(P=P, cfg=cfg, scns=scns, lane=lane, spec=spec, grid=grid,
                starts=starts, arrays=arrays, backend=conf["backend"],
                device=torch.device(device), B=B, seed=seed, cell=cell)


def plan(ctx, k):
    return ctx["P"].pipeline.plan_batch(
        ctx["scns"], ctx["starts"][k % PERTURBATION_ROWS], ctx["cfg"],
        ctx["grid"], ctx["lane"], backend=ctx["backend"], spec=ctx["spec"])


def sync(ctx):
    if ctx["device"].type == "cuda":
        torch.cuda.synchronize(ctx["device"])


def setup(cell, seed, device, log):
    ctx = program_setup(cell, seed, device, log)
    t = time.perf_counter()
    plan(ctx, PERTURBATION_ROWS - 1)       # warm-up: the cell's shapes
    sync(ctx)
    log(f"set-up: warm-up replan in {time.perf_counter() - t:.3f} s")
    return ctx


def outcome_parts(final, ok, still_dirty):
    """[5]: lanes returned without a plan (a state or control not finite),
    then the planner's own flags: lanes it marks unusable (not converged,
    not ok or still dirty after the repair ladder), and each of the three.
    The flags are answers, held against the reference by ``correct``."""
    finite = (torch.isfinite(final.xs).flatten(1).all(-1)
              & torch.isfinite(final.us).flatten(1).all(-1))
    bad = ~compare._converged(final.status)
    return torch.stack([(~finite).sum(), (bad | ~ok | still_dirty).sum(),
                        bad.sum(), (~ok).sum(), still_dirty.sum()])


def outcomes(parts, ok_name):
    """``failed`` (lanes without a plan) and the flags' counts by name."""
    no_plan, unusable, conv, not_ok, dirty = (int(x) for x in parts)
    return no_plan, {"unusable": unusable, "not_converged": conv,
                     ok_name: not_ok, "still_dirty": dirty}


def window(ctx, seconds, rec, log):
    """Replans back to back until ``seconds`` have passed and the sampled
    call has run. Returns the window's record."""
    sample_k = inputs.sample_index(ctx["seed"], SAMPLE_CALLS)
    lat, parts, kept = [], [], None
    rec.reset_window()
    sync(ctx)
    t_w = time.perf_counter()
    k = 0
    while True:
        rec.keep = k == sample_k
        t0 = time.perf_counter()
        with rec.call("plan_batch"):
            out = plan(ctx, k)
            sync(ctx)
        t1 = time.perf_counter()
        rec.keep = False
        lat.append(t1 - t0)
        parts.append(outcome_parts(out.solve, out.ok, out.still_dirty))
        if k == sample_k:
            kept = (k, out, rec.kept)
        del out
        k += 1
        if k > sample_k and t1 - t_w >= seconds:
            break
    window_s = t1 - t_w
    B = ctx["B"]
    return dict(calls=k, window_s=window_s, latencies=lat,
                work=k * B, attempted=k * B,
                outcome_parts=torch.stack(parts).sum(0).tolist(), kept=kept)


def end_to_end(win):
    from portbench import stats

    return {"replans_per_s": stats.rate(win["work"], win["window_s"])}


def failed(win):
    """Lanes returned without a plan, and the planner's flags for the log."""
    return outcomes(win["outcome_parts"], "not_ok")


def profiled(ctx, rec, n_calls=1):
    for k in range(n_calls):
        with rec.call("plan_batch"):
            plan(ctx, k)
            sync(ctx)


# -- the comparison ----------------------------------------------------------

def reference_world(cell, arrays, device):
    """The reference's own view of the inputs: config, scenarios, lane
    tuple and RoadSpec, worked out from the benchmark's arrays."""
    from portbench.ref import config as ref_config

    conf = cell.config
    np_dt = _np_dtype(conf)
    cfg = ref_config.from_dict(inputs.planner(conf))
    scns = ref_scenario.scenario_from_arrays(arrays, dtype=_torch_dtype(conf),
                                             device=device)
    left, right = inputs.road_arrays(conf)
    lane = ref_stages.make_lane_tuple(left, right, cfg, np_dt)
    spec = (ref_scenario.analytic_road_spec(dtype=np_dt)
            if conf["road_spec"] else None)
    return cfg, scns, lane, spec


def served_of(out, call):
    """The program's PlanOutput and main solve as compare.Served."""
    return compare.Served(
        main=call, final=out.solve, ok=out.ok, hits=out.solve_hits,
        pre_dirty=out.pre_hits[:, :ref_stages.NEAR_TERM_KNOTS].any(-1),
        repaired=out.repaired, still_dirty=out.still_dirty,
        coarse=out.coarse, dp_ok=out.dp_ok)


def check(ctx, win, log):
    """The compared numbers of the kept call."""
    k, out, call = win["kept"]
    return check_served(ctx["cell"], ctx["arrays"],
                        ctx["starts"][k % PERTURBATION_ROWS],
                        served_of(out, call), ctx["seed"], ctx["device"],
                        log)


def check_served(cell, arrays, starts, s: compare.Served, seed, device, log):
    cfg, scns, lane, spec = reference_world(cell, arrays, device)
    prob = ref_stages.replan_problem(scns, starts, cfg, lane, spec)
    off_dp = compare.path_off(s.coarse, prob.coarse) | (s.dp_ok != prob.dp_ok)
    off_cons = compare.constraints_off(s.main, prob)
    off_cons |= s.ok != (prob.dp_ok & prob.corridors.ok.all(-1))
    hits_main = ref_stages.recheck(scns, s.main.res.xs, cfg, spec)
    hits_final = ref_stages.recheck(scns, s.final.xs, cfg, spec)
    off_rep = compare.repair_off(s, hits_main, hits_final)
    gaps = [compare.step_residual(r.xs, r.us, prob.starts, cfg.delta_t,
                                  cfg.vehicle.wheel_base)
            for r in (s.main.res, s.final)]
    lanes = inputs.sample_lanes(seed, s.main.goals.shape[0],
                                cell.traffic["check_lanes"])
    t = time.perf_counter()
    lc = compare.solve_check(prob, s.main.res, lanes, cfg)
    log(f"check: reference float64 solve of {len(lanes)} lanes in "
        f"{time.perf_counter() - t:.3f} s")
    vals, detail = compare.numbers(off_dp | off_cons | off_rep, gaps, lc,
                                   warm=False)
    detail.update(dp_off=int(off_dp.sum()), constraints_off=int(
        off_cons.sum()), recheck_repair_off=int(off_rep.sum()))
    return vals, detail
