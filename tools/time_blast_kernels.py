#!/usr/bin/env python3
"""Times the port's three CUDA kernels of one source tree, for comparing two
trees (say a commit and its parent, exported with ``git archive``) on one
card in one call: run it once per tree, in turns (parent, change, change,
parent), each in its own process.

It calls only entry points that the port's trees share, so one version of
this tool times any of them: on the fixture in float32 at the blast
cascade's widths (B = 1024, 512, 256, 128), the sweep through its wrapper
``riccati_sweep`` (calls queued back to back, ``chip_smoke.kernel_ms``);
the cost stack with derivatives through the solver's cost-stack call
(``solver_blast._cost_stack_bl`` on the kernel route): its kernel's device
time from torch.profiler (the activities named ``stack_kernel``), and the
whole call host-paced (``chip_smoke.cuda_ms``); and the megakernel's full
solve at B=1024 (best of 3). The timing helpers and the set-up are
chip_smoke.py's, from this tool's checkout; the kernels are the tree's own,
built in its ``cilqr_tpu_torch/_build``. Prints one JSON line.

Run from the repository root:
  python3 tools/time_blast_kernels.py [--root DIR] [--label NAME]
"""

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (1024, 512, 256, 128)


def profiled_ms(fn, reps, name):
    """Mean device milliseconds of the device activities whose name holds
    ``name``, over reps calls of fn (after as many to warm the card), by
    torch.profiler; and their count."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and name in e.name]
    if not us:
        raise RuntimeError(f"the profiler recorded no device activity "
                           f"named {name}")
    return sum(us) / len(us) / 1e3, len(us)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_blast_kernels: no CUDA device")
    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms, fixture_iterate, kernel_ms, smi_line

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import cilqr_tpu_torch as P
    from cilqr_tpu_torch import solver_blast as SB
    from cilqr_tpu_torch.kernels import megasolve, sweep

    if not os.path.abspath(P.__file__).startswith(root + os.sep):
        sys.exit(f"time_blast_kernels: imported {P.__file__}, not {root}")
    cfg = P.PlannerConfig()
    ilqr, veh, dt = cfg.ilqr, cfg.vehicle, cfg.delta_t
    out = {"label": args.label, "root": root, "card": smi_line(),
           "sweep_ms": {}, "stack_ms": {}, "stack_launches": {},
           "stack_call_ms": {}}
    for w in WIDTHS:
        goals, xs, us, cbl, sargs = fixture_iterate(P, cfg, torch.float32, w)
        out["sweep_ms"][w] = kernel_ms(lambda: sweep.riccati_sweep(
            *sargs, dt=dt, wheel_base=veh.wheel_base), 100)

        def stack_call():
            return SB._cost_stack_bl(xs, us, goals, cbl, ilqr, veh, True)

        out["stack_ms"][w], out["stack_launches"][w] = profiled_ms(
            stack_call, 100, "stack_kernel")
        out["stack_call_ms"][w] = cuda_ms(stack_call, 100)
    g, s, cons = P.convert.load_fixture(dtype=torch.float32, device="cuda",
                                        batch=WIDTHS[0])
    mops = megasolve._operands(g, s, cons, ilqr, veh, dt, None,
                               megasolve.NB)[0]
    out["mega_ms_each"] = [cuda_ms(lambda: megasolve._launch(
        *mops, ilqr, veh, dt, megasolve.NB), 1) for _ in range(3)]
    out["mega_ms"] = min(out["mega_ms_each"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
