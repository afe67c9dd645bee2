#!/usr/bin/env python3
"""Where the blast path's two kernels spend their time: clock64() counters
of each phase, on one NVIDIA GPU, for the fixture's LQR iterate in float32
at B=1024 and B=128 (the widest and narrowest widths of the cascade).

Builds the kernel library with ``-DCILQR_PROFILE``, which keeps the
``CILQR_CLK`` probes of ``csrc/sweep.cu`` and ``csrc/coststack.cu`` (the
shipped build compiles them out), launches the kernels through the port's
wrappers, and prints the cycles of thread 0 of the first CTA (the first
lane's warp; the cost stack's first knot, side 0):

  sweep      prologue (staging xs, us and the first chunk), backward pass
             (of it, per step: phases 1, 2 and 3; in all: waits at the
             chunk boundaries, issuing the next chunk's copies), gnorm and
             the barrier after it, the rollouts (thread 0 runs the first
             lane's first)
  coststack  staging the segment tables, pass 1 (the lane scan of one
             side), the corridor sums of the warp's discs, and the
             hand-over and combination with the lane terms

Run from the repository root:  python3 tools/profile_blast_kernels.py
"""

import ctypes
import os
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
WIDTHS = (1024, 128)


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_blast_kernels: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import cilqr_tpu_torch as P
    from chip_smoke import narrow, realistic_iterate, smi_line
    from cilqr_tpu_torch.kernels import _build, coststack, sweep

    print(f"card: {smi_line()}", flush=True)
    # a library of its own (the flags are in its name), with the probes
    _build.NVCC_FLAGS += ("-DCILQR_PROFILE",)
    lib = _build.library()
    for name in ("sweep_read_clk", "stack_read_clk"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    clk = (ctypes.c_longlong * 16)()

    cfg = P.PlannerConfig()
    dt, L = cfg.delta_t, cfg.vehicle.wheel_base
    sweep_args, stack_args = realistic_iterate(P, cfg, torch.float32)
    for w in WIDTHS:
        sargs, cargs = narrow(sweep_args, w), narrow(stack_args, w)
        T = sargs[-1].shape[0]
        for _ in range(3):
            sweep.riccati_sweep(*sargs, dt=dt, wheel_base=L)
        torch.cuda.synchronize()
        _build.check(lib.sweep_read_clk(clk), "sweep_read_clk")
        c = list(clk)
        print(f"riccati_sweep B={w}, cycles: prologue {c[0]}, backward "
              f"{c[1]} (per step: phase 1 {c[2] / T:.0f}, phase 2 "
              f"{c[3] / T:.0f}, phase 3 {c[4] / T:.0f}; chunk waits {c[5]}, "
              f"staging {c[6]}), gnorm and barrier {c[7]}, rollout {c[8]} "
              f"({c[8] / T:.0f} a step)")
        for derivs in (True, False):
            for _ in range(3):
                coststack.corridor_lane_stack(*cargs, want_derivs=derivs)
            torch.cuda.synchronize()
            _build.check(lib.stack_read_clk(clk), "stack_read_clk")
            c = list(clk)
            print(f"corridor_lane_stack B={w} derivs={derivs}, cycles: "
                  f"staging {c[0]}, pass 1 {c[1]}, corridor sums {c[2]}, "
                  f"hand-over and lane terms {c[3]}")


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
