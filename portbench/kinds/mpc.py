"""Traffic of kind "mpc": the receding-horizon loop of the whole batch,
from one caller (a closed loop). Set-up makes every lane's initial plan
with one ``pipeline.plan_batch`` (from row 0 of the seed's start
perturbations); the window then runs episodes of ``episode_cycles`` cycles
from those plans, each cycle one ``mpc.mpc_step_batch`` of the batch,
timed as one call."""

from __future__ import annotations

import time

import torch

from portbench import compare, inputs, stats
from portbench.kinds import replan
from portbench.ref import stages as ref_stages

SAMPLE_EPISODES = 2       # the compared cycle lies in the first two episodes


def _carry0(P, out):
    xs = out.solve.xs
    B = xs.shape[0]
    return P.mpc.MpcCarry(
        xs=xs, us=out.solve.us,
        cycle_time=torch.zeros(B, dtype=xs.dtype, device=xs.device),
        no_repair=torch.zeros(B, dtype=torch.bool, device=xs.device))


def step(ctx, carry):
    return ctx["P"].mpc.mpc_step_batch(ctx["scns"], carry, ctx["cfg"],
                                       ctx["lane"], backend=ctx["backend"],
                                       spec=ctx["spec"])


def setup(cell, seed, device, log):
    ctx = replan.program_setup(cell, seed, device, log)
    t = time.perf_counter()
    out0 = replan.plan(ctx, 0)
    ctx["carry0"] = _carry0(ctx["P"], out0)
    del out0
    replan.sync(ctx)
    log(f"set-up: the initial plans in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    step(ctx, ctx["carry0"])               # warm-up: one cycle
    replan.sync(ctx)
    log(f"set-up: warm-up cycle in {time.perf_counter() - t:.3f} s")
    return ctx


def window(ctx, seconds, rec, log):
    """Cycles back to back, in episodes from the initial plans, until
    ``seconds`` have passed and the sampled cycle has run."""
    E = ctx["cell"].traffic["episode_cycles"]
    sample_k = inputs.sample_index(ctx["seed"], SAMPLE_EPISODES * E)
    lat, parts, kept = [], [], None
    rec.reset_window()
    replan.sync(ctx)
    t_w = time.perf_counter()
    k = 0
    carry = ctx["carry0"]
    while True:
        if k % E == 0:
            carry = ctx["carry0"]
        rec.keep = k == sample_k
        t0 = time.perf_counter()
        with rec.call("mpc_step_batch"):
            nxt, out = step(ctx, carry)
            replan.sync(ctx)
        t1 = time.perf_counter()
        rec.keep = False
        lat.append(t1 - t0)
        parts.append(replan.outcome_parts(out.solve, out.corridor_ok,
                                          out.still_dirty))
        if k == sample_k:
            kept = (carry, nxt, out, rec.kept)
        del out
        carry = nxt
        k += 1
        if k > sample_k and t1 - t_w >= seconds:
            break
    window_s = t1 - t_w
    B = ctx["B"]
    lat_ms = [x * 1e3 for x in lat]
    log(f"window: {k} cycles, call latency median "
        f"{stats.percentile(lat_ms, 50):.3f} ms, p90 "
        f"{stats.percentile(lat_ms, 90):.3f} ms over {len(lat_ms)} calls")
    return dict(calls=k, window_s=window_s, latencies=lat, work=k * B,
                attempted=k * B,
                outcome_parts=torch.stack(parts).sum(0).tolist(), kept=kept)


def end_to_end(win):
    return {"lane_cycles_per_s": stats.rate(win["work"], win["window_s"]),
            "call_p90_ms": stats.percentile(
                [x * 1e3 for x in win["latencies"]], 90)}


def failed(win):
    return replan.outcomes(win["outcome_parts"], "corridor_failed")


def profiled(ctx, rec, n_calls=4):
    carry = ctx["carry0"]
    for _ in range(n_calls):
        with rec.call("mpc_step_batch"):
            carry, _ = step(ctx, carry)
            replan.sync(ctx)


# -- the comparison ----------------------------------------------------------

def served_of(out, carry_out, call):
    return compare.Served(
        main=call, final=out.solve, ok=out.corridor_ok, hits=out.solve_hits,
        pre_dirty=out.pre_near_hits, repaired=out.repaired,
        still_dirty=out.still_dirty, carry_out=(carry_out, out.near_hits))


def check(ctx, win, log):
    carry_in, carry_out, out, call = win["kept"]
    return check_served(ctx["cell"], ctx["arrays"], carry_in,
                        served_of(out, carry_out, call), ctx["seed"],
                        ctx["device"], log)


def check_served(cell, arrays, carry_in, s: compare.Served, seed, device,
                 log):
    """The compared numbers of one cycle: ``carry_in`` is the program's
    state the cycle started from (the reference follows the loop from it)."""
    cfg, scns, lane, spec = replan.reference_world(cell, arrays, device)
    prob = ref_stages.cycle_problem(scns, carry_in.xs, carry_in.us,
                                    carry_in.cycle_time, cfg, lane)
    off_cons = compare.constraints_off(s.main, prob)
    off_cons |= s.ok != prob.corridors.ok.all(-1)
    hits_main = ref_stages.recheck(scns, s.main.res.xs, cfg, spec,
                                   t0=prob.t0)
    hits_final = ref_stages.recheck(scns, s.final.xs, cfg, spec, t0=prob.t0)
    off_rep = compare.repair_off(s, hits_main, hits_final,
                                 eligible=~carry_in.no_repair)
    carry, near_hits = s.carry_out
    off_carry = ~compare._same_plan(carry, s.final)
    off_carry |= carry.cycle_time != prob.t0
    off_carry |= carry.no_repair != (carry_in.no_repair | s.still_dirty)
    off_carry |= near_hits != s.still_dirty
    gaps = [compare.step_residual(r.xs, r.us, prob.starts, cfg.delta_t,
                                  cfg.vehicle.wheel_base, warm=prob.warm)
            for r in (s.main.res, s.final)]
    lanes = inputs.sample_lanes(seed, s.main.goals.shape[0],
                                cell.traffic["check_lanes"])
    t = time.perf_counter()
    lc = compare.solve_check(prob, s.main.res, lanes, cfg)
    log(f"check: reference float64 solve of {len(lanes)} lanes in "
        f"{time.perf_counter() - t:.3f} s")
    vals, detail = compare.numbers(off_cons | off_rep | off_carry, gaps,
                                   lc, warm=True)
    detail.update(constraints_off=int(off_cons.sum()),
                  recheck_repair_off=int(off_rep.sum()),
                  carry_off=int(off_carry.sum()))
    return vals, detail
