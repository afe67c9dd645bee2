"""Traffic of kind "replan_fleet": full replans of a batch whose lanes are
each on a road of their own (lane i on road i of the configuration's
family, ``fleet``), back to back from one caller (a closed loop). Set-up
draws the roads and scenarios from the seed and builds the program's road
library from them; call k replans every lane through
``pipeline.plan_batch`` with the library, from the configuration's start
moved by row k of the seed's perturbations. The comparison runs the
single-road reference road by road on a seeded sample (``fleet_ref``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import fleet, fleet_ref, inputs
from portbench.kinds import replan

PERTURBATION_ROWS = replan.PERTURBATION_ROWS
SAMPLE_CALLS = replan.SAMPLE_CALLS


def program_setup(cell, seed, device, log, arrays=None):
    """The program's set-up: its config, the scenarios on the device (a
    road each), and the road library of their roads, built by the
    program's own functions in one pass (the lane constraints from the
    roads' padded float64 polylines in the configuration's type, as a
    one-road cell's lane tuple is built)."""
    import cilqr_tpu_torch as P
    from cilqr_tpu_torch import config as P_config
    from cilqr_tpu_torch import pipeline, scenario

    if not hasattr(pipeline, "road_library"):
        raise RuntimeError("this program plans a batch on one road only: "
                           "it has no road library (pipeline.road_library)")
    conf, traffic = cell.config, cell.traffic
    B = traffic["batch"]
    t = time.perf_counter()
    if arrays is None:
        arrays, _ = fleet.fleet_arrays(conf, seed, B)
    dy = inputs.perturbations(seed, PERTURBATION_ROWS, B,
                              traffic["perturb_y"])
    log(f"set-up: {B} roads and scenarios and {PERTURBATION_ROWS} rows of "
        f"start perturbations generated in {time.perf_counter() - t:.3f} s")
    dtype, np_dt = replan._torch_dtype(conf), replan._np_dtype(conf)
    cfg = P_config.from_dict(inputs.planner(conf))
    scns = scenario.scenario_from_arrays(arrays, dtype=dtype, device=device)
    sides = tuple(arrays[k + "_barrier_" + f] for k in ("left", "right")
                  for f in ("xy", "mask"))
    t = time.perf_counter()
    library = pipeline.road_library(scns, cfg, lanes=sides, dtype=np_dt)
    sync_dev(device)
    log(f"set-up: road library of {library.n_roads} roads "
        f"({library.dilated.numel()} table bytes) in "
        f"{time.perf_counter() - t:.3f} s")
    starts = torch.as_tensor(
        np.stack([inputs.starts(conf, row) for row in dy]), dtype=dtype,
        device=device)                                   # [rows, B, 4]
    return dict(P=P, cfg=cfg, scns=scns, library=library, starts=starts,
                arrays=arrays, backend=conf["backend"],
                device=torch.device(device), B=B, seed=seed, cell=cell)


def sync_dev(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def plan(ctx, k):
    return ctx["P"].pipeline.plan_batch(
        ctx["scns"], ctx["starts"][k % PERTURBATION_ROWS], ctx["cfg"],
        backend=ctx["backend"], library=ctx["library"])


def setup(cell, seed, device, log):
    ctx = program_setup(cell, seed, device, log)
    t = time.perf_counter()
    plan(ctx, PERTURBATION_ROWS - 1)       # warm-up: the cell's shapes
    replan.sync(ctx)
    log(f"set-up: warm-up replan in {time.perf_counter() - t:.3f} s")
    return ctx


def window(ctx, seconds, rec, log):
    """Replans back to back until ``seconds`` have passed and the sampled
    call has run (kinds/replan's window, with the library)."""
    sample_k = inputs.sample_index(ctx["seed"], SAMPLE_CALLS)
    lat, parts, kept = [], [], None
    rec.reset_window()
    replan.sync(ctx)
    t_w = time.perf_counter()
    k = 0
    while True:
        rec.keep = k == sample_k
        t0 = time.perf_counter()
        with rec.call("plan_batch"):
            out = plan(ctx, k)
            replan.sync(ctx)
        t1 = time.perf_counter()
        rec.keep = False
        lat.append(t1 - t0)
        parts.append(replan.outcome_parts(out.solve, out.ok,
                                          out.still_dirty))
        if k == sample_k:
            kept = (k, out, rec.kept)
        del out
        k += 1
        if k > sample_k and t1 - t_w >= seconds:
            break
    B = ctx["B"]
    return dict(calls=k, window_s=t1 - t_w, latencies=lat, work=k * B,
                attempted=k * B,
                outcome_parts=torch.stack(parts).sum(0).tolist(), kept=kept)


end_to_end = replan.end_to_end
failed = replan.failed


def profiled(ctx, rec, n_calls=1):
    for k in range(n_calls):
        with rec.call("plan_batch"):
            plan(ctx, k)
            replan.sync(ctx)


# -- the comparison ----------------------------------------------------------

def roads_of(B):
    """Each lane's road: lane i on road i."""
    return np.arange(B)


def check(ctx, win, log):
    """The compared numbers of the kept call, on the sampled roads."""
    k, out, call = win["kept"]
    cell = ctx["cell"]
    lanes, _ = fleet_ref.sample(cell, ctx["seed"],
                                roads_of(cell.traffic["batch"]))
    s = fleet_ref.take(replan.served_of(out, call), lanes)
    return check_served(cell, ctx["arrays"],
                        ctx["starts"][k % PERTURBATION_ROWS], s,
                        ctx["seed"], ctx["device"], log)


def check_served(cell, arrays, starts, s, seed, device, log):
    """The numbers of a Served over the sampled lanes, in their order."""
    lanes, groups = fleet_ref.sample(cell, seed,
                                     roads_of(cell.traffic["batch"]))
    t = time.perf_counter()
    vals, detail = fleet_ref.check_served(cell, arrays, starts, s, lanes,
                                          groups, seed, device, log)
    log(f"check: the reference on {len(groups)} roads in "
        f"{time.perf_counter() - t:.3f} s")
    return vals, detail


def control_check(ctx, win, log):
    """The control's numbers on the kept call (``calibrate_kinds``): the
    sampled roads' reference in bfloat16 in the program's place."""
    k = win["kept"][0]
    cell, seed = ctx["cell"], ctx["seed"]
    starts = ctx["starts"][k % PERTURBATION_ROWS]
    lanes, groups = fleet_ref.sample(cell, seed,
                                     roads_of(cell.traffic["batch"]))
    s = fleet_ref.control_served(cell, ctx["arrays"], starts, lanes, groups,
                                 ctx["device"])
    return check_served(cell, ctx["arrays"], starts, s, seed,
                        ctx["device"], log)
