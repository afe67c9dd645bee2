#!/usr/bin/env python3
"""Where a blast solve's time goes: one solve of the fixture at B=1024 in
float32 through ``batch.solve_batch(backend="blast")`` (the sweep and
cost-stack kernels), on one NVIDIA GPU, under ``torch.profiler``.

Prints:
  - device milliseconds by kernel name (the profiler's CUDA activities),
    with their launch counts, and their total;
  - the blast kernels' launches per cascade width (the wrappers' counts
    in ``profiling.counters``);
  - the solve's trips and host syncs (the program's tracer on);
  - the device busy share: the union of the solve's device activity over
    the wall time of the same solve without the profiler (host clock, after
    a warm-up solve, each ended by a synchronize).

Run from the repository root:  python3 tools/profile_blast.py
"""

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 1024
TOP = 25   # kernel names listed


def busy_union_us(events):
    """Length of the union of the device activities' intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_blast: no CUDA device; this tool runs only on a GPU")
    sys.path.insert(0, ROOT)
    import cilqr_tpu_torch as P
    from chip_smoke import launch_widths, reset_counts, smi_line

    smi = smi_line()
    print(f"card name, power limit (nvidia-smi): {smi}", flush=True)
    cfg = P.PlannerConfig()
    ilqr, veh, dt = cfg.ilqr, cfg.vehicle, cfg.delta_t
    g, s, cons = P.convert.load_fixture(dtype=torch.float32, device="cuda",
                                        batch=B)

    def solve():
        res = P.batch.solve_batch(g, s, cons, ilqr, veh, dt)
        torch.cuda.synchronize()
        return res

    solve()   # builds the kernels, warms the caches
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = min(walls)

    reset_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with P.profiling.tracing(), \
            torch.profiler.profile(activities=acts) as prof:
        res = solve()
    traced = P.profiling.collect().counters
    trips, syncs = traced["blast.trips"], traced["host_syncs"]
    conv = int(torch.isin(res.status, torch.tensor(
        [1, 2, 3], device=res.status.device)).sum())

    # the tracer's ranges are mirrored onto the device's timeline as user
    # annotations: host ranges, not device work
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    if not dev_events:
        sys.exit("profile_blast: the profiler recorded no device time")
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    rows = sorted(((k, n, us) for k, (n, us) in by_name.items()),
                  key=lambda r: -r[2])
    kernel_total = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    busy = busy_union_us(dev_events) / 1e3
    print(f"blast solve, fixture B={B} float32: converged {conv}/{B}; "
          f"trips {trips}, host syncs {syncs}")
    print(f"device activities: {len(dev_events)}, summed {kernel_total:.3f} "
          f"ms, busy (union) {busy:.3f} ms; wall without the profiler "
          f"{wall:.1f} ms (best of {[round(w, 1) for w in walls]}): device "
          f"busy share {busy / wall:.4f}")
    print(f"device ms by kernel name (top {TOP} of {len(rows)}):")
    for key, count, us in rows[:TOP]:
        print(f"  {us / 1e3:10.3f} ms  {count:7d} x  {key[:100]}")
    widths = {name: launch_widths(name)
              for name in ("riccati_sweep", "corridor_lane_stack")}
    print(f"launches by cascade width: {widths}")
    print(json.dumps({"card": smi, "B": B, "trips": trips,
                      "host_syncs": syncs, "converged": conv,
                      "device_busy_ms": busy, "device_summed_ms":
                      kernel_total, "wall_ms": wall,
                      "busy_share": busy / wall,
                      "launches_by_width": widths,
                      "device_ms_by_kernel": {k: us / 1e3
                                              for k, _, us in rows[:TOP]}}))


if __name__ == "__main__":
    main()
