"""Readings that the limits of ``correct`` are set from, for one cell, in
one process at the cell's own size and load:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 3 \
        [--faults unchanged,block --fault-seeds 1,2,3] [--dump DIR]

For each seed the program runs a short window of the cell's traffic and
its kept call is compared with the reference (the lower readings); on
each control seed the control (``control``: the reference in bfloat16 in
the program's place) answers the same call and is compared the same way
(the upper readings). Then, for each of ``--faults`` in turn, the
program's batch solve is broken underneath the harness (``plant``) and
each fault seed gives a reading of the broken program. ``--dump`` writes
each reading's sampled lanes (``compare.LaneCheck``) to
``DIR/<cell>.<side>.<fault>.<seed>.npz``. One JSON line a reading. The benchmark's own runs never run the control."""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np

import torch

from portbench import compare, control, registry, run
from portbench.recorder import Recorder

BLOCK = 128   # lanes of one megakernel exit block, and of a ladder launch


def plant(fault, block=BLOCK):
    """Break the program's batch solve (as ``pipeline`` and ``mpc`` call it,
    the repair ladder's too) so that it hands back its initial guess, the
    LQR guess or an MPC cycle's shifted plan, each lane flagged as the
    solve concluded it: on every lane (``unchanged``), or on the first
    ``block`` lanes of every launch (``block``). Returns the undo."""
    from cilqr_tpu_torch import mpc, pipeline

    undo = []
    for mod in (pipeline, mpc):
        orig = mod.solve_batch

        def broken(*args, _orig=orig, **kwargs):
            res = _orig(*args, **kwargs)
            n = res.xs.shape[0] if fault == "unchanged" else block
            xs, us = res.xs.clone(), res.us.clone()
            xs[:n], us[:n] = res.init_xs[:n], res.init_us[:n]
            return dataclasses.replace(res, xs=xs, us=us)

        mod.solve_batch = broken
        undo.append((mod, orig))

    def restore():
        for mod, orig in undo:
            mod.solve_batch = orig

    return restore


class _Capture:
    """Keeps the LaneCheck of the last comparison."""

    def __init__(self):
        self.last = None
        self._orig = compare.solve_check

    def __enter__(self):
        def solve_check(*args, **kwargs):
            self.last = self._orig(*args, **kwargs)
            return self.last

        compare.solve_check = solve_check
        return self

    def __exit__(self, *exc):
        compare.solve_check = self._orig


def _dump(dump, cell, side, fault, seed, lc):
    if dump is None or lc is None:
        return
    dump.mkdir(parents=True, exist_ok=True)
    np.savez(dump / f"{cell.name}.{side}.{fault or 'none'}.{seed}.npz",
             **{f.name: getattr(lc, f.name).detach().cpu().double().numpy()
                for f in dataclasses.fields(lc)})


def _state(kind, ctx, win):
    if kind == "replan":
        k = win["kept"][0]
        return ctx["starts"][k % ctx["starts"].shape[0]]
    return win["kept"][0]


def readings(cell, seeds, control_seeds, seconds, device="cuda", emit=print,
             fault=None, dump=None, block=BLOCK):
    kind = cell.traffic["kind"]
    mix = cell.kind()
    restore = plant(fault, block) if fault else None
    rec = Recorder().install()
    try:
        with _Capture() as cap:
            for seed in seeds:
                rec.kept = None
                t = time.perf_counter()
                ctx = mix.setup(cell, seed, device, run.log)
                win = mix.window(ctx, seconds, rec, run.log)
                vals, detail = mix.check(ctx, win, run.log)
                emit(json.dumps({"seed": seed, "side": "program",
                                 "fault": fault, **vals, "detail": detail,
                                 "s": time.perf_counter() - t}))
                _dump(dump, cell, "program", fault, seed, cap.last)
                if seed in control_seeds:
                    t = time.perf_counter()
                    state = _state(kind, ctx, win)
                    arrays = ctx["arrays"]
                    s = control.served(kind, cell, arrays, state, device)
                    vals, detail = mix.check_served(
                        cell, arrays, state, s, seed, device, run.log)
                    emit(json.dumps({"seed": seed, "side": "control", **vals,
                                     "detail": detail,
                                     "s": time.perf_counter() - t}))
                    _dump(dump, cell, "control", None, seed, cap.last)
                del ctx, win
                if device.startswith("cuda"):
                    torch.cuda.empty_cache()
    finally:
        rec.uninstall()
        if restore:
            restore()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--cost-lanes", type=int, default=0,
                    help="lanes of the float64 reference solve (default: "
                    "the traffic's check_lanes)")
    ap.add_argument("--faults", default="",
                    help="comma-separated: unchanged, block")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--dump", type=pathlib.Path)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    cell = registry.cell(args.workload)
    if args.cost_lanes:
        cell.traffic["check_lanes"] = args.cost_lanes
    device, info = run._device(cell.chips, "cuda")
    run.log(f"device: {info}; nvidia-smi: {run.power_limit()}")
    readings(cell, seeds, ctl, args.seconds, device, dump=args.dump)
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    for fault in (f for f in args.faults.split(",") if f):
        if fault not in ("unchanged", "block"):
            raise SystemExit(f"unknown fault {fault!r}")
        readings(cell, fault_seeds, set(), args.seconds, device,
                 fault=fault, dump=args.dump)


if __name__ == "__main__":
    main()
