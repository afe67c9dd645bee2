#!/usr/bin/env python3
"""Where a replan's time goes: one ``pipeline.plan_batch`` of scenarios
0..1023 in float32 (bench.py's set-up, chip_smoke.py's ``replan_setup``),
stage by stage (DP, corridors, prep + solve, re-check + repair), through
``"blast"`` and through ``"mega"``, on one NVIDIA GPU.

For each stage it prints the wall time of the stage (host clock around a
synchronised call, best of 3 after a warm-up), the device time under
``torch.profiler`` (the union of the stage's device activities), their
ratio (the device busy share), the kernel launches, and the top kernels by
device time; then the same for the whole replan.

Run from the repository root:  python3 tools/profile_replan.py
"""

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 1024
TOP = 6   # kernel names listed per stage


def stages(P, cfg, setup, backend):
    """The replan as four callables, each taking the one before's output
    (DP, corridors, prep and solve, re-check and repair)."""
    from cilqr_tpu_torch import batch, corridor, dp, pipeline

    scns, starts, lane, spec = setup

    def run_dp(_):
        return dp.plan(scns, starts[:, 0], starts[:, 1], starts[:, 2], cfg,
                       spec=spec)

    def run_cor(d):
        return d, corridor.plan_corridors(scns, d.traj, cfg.corridor, lane)

    def run_solve(dc):
        d, cors = dc
        cons = pipeline.prep_constraints(cors, cfg)
        goals = pipeline.coarse_to_states(d.traj)
        s6 = pipeline.start_states(starts, goals.dtype)
        return cons, goals, s6, batch.solve_batch(
            goals, s6, cons, cfg.ilqr, cfg.vehicle, cfg.delta_t,
            backend=backend)

    def run_repair(x):
        cons, goals, s6, res = x
        hits = pipeline._recheck_solution(scns, res.xs, cfg, spec)
        return pipeline._repair_batch(scns, res, hits, goals, s6, cons, cfg,
                                      spec, backend=backend)

    return (("dp", run_dp), ("corridors", run_cor),
            ("prep + solve", run_solve), ("re-check + repair", run_repair))


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_replan: no CUDA device; this tool runs only on a "
                 "GPU")
    sys.path.insert(0, ROOT)
    import cilqr_tpu_torch as P
    from chip_smoke import replan_setup, smi_line
    from tools.profile_blast import busy_union_us

    print(f"card name, power limit (nvidia-smi): {smi_line()}", flush=True)
    cfg = P.PlannerConfig()
    setup = replan_setup(P, range(B))
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    for backend in ("blast", "mega"):
        steps = stages(P, cfg, setup, backend)
        walls = {name: [] for name, _ in steps}
        for _ in range(4):     # a warm-up, then 3 timed
            x = None
            for name, fn in steps:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = fn(x)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        x = None
        tot_wall = tot_busy = 0.0
        print(f"replan B={B} float32, backend={backend}:", flush=True)
        for name, fn in steps:
            with torch.profiler.profile(activities=act) as prof:
                x = fn(x)
                torch.cuda.synchronize()
            dev = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            if not dev:
                sys.exit("profile_replan: the profiler recorded no device "
                         "time")
            busy = busy_union_us(dev) / 1e3
            wall = min(walls[name][1:])
            tot_wall += wall
            tot_busy += busy
            by_name = {}
            for e in dev:
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
            print(f"  {name}: wall {wall:.1f} ms (best of "
                  f"{[round(w, 1) for w in walls[name][1:]]}), device busy "
                  f"{busy:.1f} ms, share {busy / wall:.3f}, {len(dev)} "
                  f"device activities", flush=True)
            for k, (ms, n) in top:
                print(f"      {ms:9.2f} ms {n:6d}x  {k[:90]}")
        print(f"  whole replan: wall {tot_wall:.1f} ms, device busy "
              f"{tot_busy:.1f} ms, share {tot_busy / tot_wall:.3f}",
              flush=True)


if __name__ == "__main__":
    main()
