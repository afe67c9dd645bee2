"""``calibrate``'s readings for cells of the kinds it does not know
(``replan_online``, ``replan_fleet``), in one process at the cell's own
size and load:

    python3 -m portbench.calibrate_kinds --workload <cell> --seeds 1,2 \
        --control-seeds 1,2,3 --seconds 3 \
        [--faults unchanged,block,rotate --fault-seeds 1,2,3]

As ``calibrate``: each seed's kept call against the reference (the lower
readings), on each control seed the kind's control (``control_check``:
the reference in bfloat16 in the program's place; the upper readings),
then each fault planted under the harness: ``calibrate.plant``'s solve
faults, and ``rotate``, each lane handed the road of the lane after it
(``pipeline.lane_roads`` given the road indices rolled by one). One JSON
line a reading."""

from __future__ import annotations

import argparse
import json
import time

import torch

from portbench import calibrate, registry, run
from portbench.recorder import Recorder


def plant_rotate():
    """Hand every lane the next lane's road. Returns the undo."""
    from cilqr_tpu_torch import pipeline

    orig = pipeline.lane_roads

    def rotated(library, roads):
        return orig(library, torch.roll(roads, 1))

    pipeline.lane_roads = rotated

    def restore():
        pipeline.lane_roads = orig

    return restore


def plant(fault):
    return plant_rotate() if fault == "rotate" else calibrate.plant(fault)


def readings(cell, seeds, control_seeds, seconds, device="cuda", emit=print,
             fault=None):
    mix = cell.kind()
    restore = plant(fault) if fault else None
    rec = Recorder().install()
    try:
        for seed in seeds:
            rec.kept = None
            t = time.perf_counter()
            ctx = mix.setup(cell, seed, device, run.log)
            win = mix.window(ctx, seconds, rec, run.log)
            vals, detail = mix.check(ctx, win, run.log)
            emit(json.dumps({"seed": seed, "side": "program",
                             "fault": fault, **vals, "detail": detail,
                             "s": time.perf_counter() - t}))
            if seed in control_seeds:
                t = time.perf_counter()
                vals, detail = mix.control_check(ctx, win, run.log)
                emit(json.dumps({"seed": seed, "side": "control", **vals,
                                 "detail": detail,
                                 "s": time.perf_counter() - t}))
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
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", default="",
                    help="comma-separated: unchanged, block, rotate")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    cell = registry.cell(args.workload)
    device, info = run._device(cell.chips, "cuda")
    run.log(f"device: {info}; nvidia-smi: {run.power_limit()}")
    readings(cell, seeds, ctl, args.seconds, device)
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    for fault in (f for f in args.faults.split(",") if f):
        if fault not in ("unchanged", "block", "rotate"):
            raise SystemExit(f"unknown fault {fault!r}")
        readings(cell, fault_seeds, set(), args.seconds, device,
                 fault=fault)


if __name__ == "__main__":
    main()
