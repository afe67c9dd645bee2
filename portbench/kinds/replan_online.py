"""Traffic of kind "replan_online": kinds/replan's full replans, back to
back from one caller, at the small batch of an onboard or shadow-mode
planner that replans every cycle; besides the rate it reports the 90th
percentile of the window's call latencies against the 0.1 s cycle
(planner_config.h:94).

Every call poses problems the caller has not posed before: set-up draws a
pool of ``pool_batches`` batches' worth of scenarios from the seed
(``inputs.scenario_arrays``, fresh for every seed), and call k replans
``batch`` of them, row k of the seed's draws of distinct pool scenarios,
from the configuration's start moved by row k of the seed's
perturbations. So a window mixes the calls whose problems leave a lane
dirty (the repair ladder runs) with those that leave none, as a planner
meets them."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import control, inputs, stats
from portbench.kinds import replan

PERTURBATION_ROWS = replan.PERTURBATION_ROWS   # calls before draws repeat
SAMPLE_CALLS = replan.SAMPLE_CALLS
WARM_CALLS = 4        # warm-up calls, each on draws of its own

failed = replan.failed


def pool_size(cell):
    return cell.traffic["batch"] * cell.traffic["pool_batches"]


def draws(cell, seed):
    """[PERTURBATION_ROWS, batch] int64: row k holds call k's pool
    scenarios, distinct, drawn from the seed."""
    rng = np.random.default_rng([int(seed) & inputs.SEED_MASK, 6])
    n, b = pool_size(cell), cell.traffic["batch"]
    return np.stack([rng.choice(n, size=b, replace=False)
                     for _ in range(PERTURBATION_ROWS)])


def take_arrays(arrays, idx):
    """The scenario arrays of pool scenarios ``idx``."""
    out = {k: v[idx] for k, v in arrays.items() if k != "centerline"}
    out["centerline"] = {k: v[idx] for k, v in arrays["centerline"].items()}
    return out


def setup(cell, seed, device, log):
    t = time.perf_counter()
    pool = inputs.scenario_arrays(cell.config, seed, pool_size(cell))
    log(f"set-up: a pool of {pool_size(cell)} scenarios generated in "
        f"{time.perf_counter() - t:.3f} s")
    ctx = replan.program_setup(cell, seed, device, log, arrays=pool)
    ctx["draws"] = torch.as_tensor(draws(cell, seed), device=device)
    t = time.perf_counter()
    for k in range(PERTURBATION_ROWS - WARM_CALLS, PERTURBATION_ROWS):
        plan(ctx, k, scenarios(ctx, k))     # warm-up: the cell's shapes
    replan.sync(ctx)
    log(f"set-up: {WARM_CALLS} warm-up replans in "
        f"{time.perf_counter() - t:.3f} s")
    return ctx


def scenarios(ctx, k):
    """Call k's scenarios, gathered from the pool on the device."""
    idx = ctx["draws"][k % PERTURBATION_ROWS]
    return ctx["scns"].map(lambda a: a[idx])


def plan(ctx, k, scns):
    return ctx["P"].pipeline.plan_batch(
        scns, ctx["starts"][k % PERTURBATION_ROWS], ctx["cfg"], ctx["grid"],
        ctx["lane"], backend=ctx["backend"], spec=ctx["spec"])


def window(ctx, seconds, rec, log):
    """Replans back to back until ``seconds`` have passed and the sampled
    call has run (kinds/replan's window). A call's scenarios are gathered
    before its clock starts, as a planner is handed its inputs."""
    sample_k = inputs.sample_index(ctx["seed"], SAMPLE_CALLS)
    lat, parts, kept = [], [], None
    rec.reset_window()
    replan.sync(ctx)
    t_w = time.perf_counter()
    k = 0
    while True:
        scns = scenarios(ctx, k)
        replan.sync(ctx)
        rec.keep = k == sample_k
        t0 = time.perf_counter()
        with rec.call("plan_batch"):
            out = plan(ctx, k, scns)
            replan.sync(ctx)
        t1 = time.perf_counter()
        rec.keep = False
        lat.append(t1 - t0)
        parts.append(replan.outcome_parts(out.solve, out.ok,
                                          out.still_dirty))
        if k == sample_k:
            kept = (k, out, rec.kept)
        del out, scns
        k += 1
        if k > sample_k and t1 - t_w >= seconds:
            break
    B = ctx["B"]
    return dict(calls=k, window_s=t1 - t_w, latencies=lat, work=k * B,
                attempted=k * B,
                outcome_parts=torch.stack(parts).sum(0).tolist(), kept=kept)


def end_to_end(win):
    """``replans_per_s`` and ``call_p90_ms``: the 90th percentile of every
    call of the window, call to its synchronise."""
    out = replan.end_to_end(win)
    out["call_p90_ms"] = stats.percentile(
        [x * 1e3 for x in win["latencies"]], 90)
    return out


def profiled(ctx, rec, n_calls=1):
    for k in range(n_calls):
        scns = scenarios(ctx, k)
        with rec.call("plan_batch"):
            plan(ctx, k, scns)
            replan.sync(ctx)


# -- the comparison ----------------------------------------------------------

def kept_problems(ctx, win):
    """The kept call's scenario arrays and starts."""
    k = win["kept"][0]
    idx = draws(ctx["cell"], ctx["seed"])[k % PERTURBATION_ROWS]
    return (take_arrays(ctx["arrays"], idx),
            ctx["starts"][k % PERTURBATION_ROWS])


def check(ctx, win, log):
    """The compared numbers of the kept call (kinds/replan's comparison on
    the call's own scenarios)."""
    _, out, call = win["kept"]
    arrays, starts = kept_problems(ctx, win)
    return replan.check_served(ctx["cell"], arrays, starts,
                               replan.served_of(out, call), ctx["seed"],
                               ctx["device"], log)


def control_check(ctx, win, log):
    """The control's numbers on the kept call (``calibrate_kinds``): the
    reference in bfloat16 in the program's place."""
    arrays, starts = kept_problems(ctx, win)
    s = control.replan_served(ctx["cell"], arrays, starts, ctx["device"])
    return replan.check_served(ctx["cell"], arrays, starts, s, ctx["seed"],
                               ctx["device"], log)
