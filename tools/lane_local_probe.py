#!/usr/bin/env python3
"""Locates where a lane's result depends on the batch it sits in: runs the
stages of ``pipeline.plan_batch`` (scenarios, DP, corridors, constraint
prep, the LQR initial guess, the re-check and, on a 128-lane block, the
mega and blast solves) on a batch of scenarios and on a window of its rows
alone, each stage from the same inputs (the full batch's rows), and
compares the window's outputs with the full batch's rows bit for bit.
Then, inside the DP, it compares every PyTorch operation of one chunk
(``dp._plan_chunk``) run on the rows of the full batch's chunk that holds
the window and on the window alone, by a digest of each output's rows, and
names the first operation whose rows differ, where it was called and
whether its inputs were equal.

Set-up: chip_smoke.py's replan set-up (scenarios 0..N-1, unperturbed
starts, float32, the road's lane constraints and RoadSpec) on
``--device`` (``cpu`` for a rehearsal at a small size, with ``--probes``
to force the DP's chunks). Last, cumsum alone: the first w of 1,024 rows
summed as a batch of w against the batch of 1,024. Prints one JSON
line.

Run from the repository root:
  python3 tools/lane_local_probe.py [--root DIR] [--seeds 256]
      [--window 106:128] [--device cuda] [--probes N]
"""

import argparse
import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bits(t):
    """The tensor's bit patterns as int64 rows [t.shape[0], -1]."""
    t = t.detach().contiguous()
    if t.dtype == torch.float32:
        t = t.view(torch.int32)
    elif t.dtype == torch.float64:
        t = t.view(torch.int64)
    elif t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.to(torch.int64).reshape(t.shape[0], -1)


def row_digest(t):
    """One int64 per row of t, a weighted sum of its bit patterns (exact:
    integer sums wrap the same way in any order)."""
    b = bits(t)
    w = (torch.arange(b.shape[1], device=b.device, dtype=torch.int64)
         * 2654435761 + 97531)
    return (b * w).sum(-1)


def equal_rows(a, b):
    """a's rows equal b's bit for bit (shapes equal, NaNs by pattern)."""
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


def where_called():
    """The innermost frame of the port's package that made the call."""
    for fr in reversed(traceback.extract_stack()):
        if "cilqr_tpu_torch" in fr.filename:
            return (f"{os.path.relpath(fr.filename, HERE)}:{fr.lineno} "
                    f"{fr.line.strip()[:90]}")
    return "?"


class Recorder(TorchDispatchMode):
    """Records every operation: its name, where it was called and, for
    each output whose leading axis is the batch (``rows``), the digests of
    the rows [lo, lo + n). With ``keep`` = an operation's index, also keeps
    that operation's inputs and outputs."""

    def __init__(self, rows, lo, n, keep=None):
        super().__init__()
        self.rows, self.lo, self.n, self.keep = rows, lo, n, keep
        self.ops = []
        self.kept = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        dig = []
        for o in outs:
            if (isinstance(o, torch.Tensor) and o.dim()
                    and o.shape[0] == self.rows and o.numel()):
                dig.append((tuple(o.shape[1:]),
                            row_digest(o[self.lo:self.lo + self.n])))
            else:
                dig.append(None)
        if len(self.ops) == self.keep:
            ins = [a for a in list(args) + list((kwargs or {}).values())
                   if isinstance(a, torch.Tensor)]
            self.kept = ([a.clone() for a in ins],
                         [o.clone() for o in outs
                          if isinstance(o, torch.Tensor)])
        self.ops.append((str(func), where_called(), dig))
        return out


def op_diff(run_full, run_win, rows_full, rows_win, lo, n):
    """The operations of run_full (rows [lo, lo+n) of a batch of
    rows_full) and run_win (a batch of rows_win = n) side by side; the
    first ones whose batch rows differ."""
    with torch.no_grad():
        with Recorder(rows_full, lo, n) as rf:
            run_full()
        with Recorder(rows_win, 0, n) as rw:
            run_win()
    if [o[0] for o in rf.ops] != [o[0] for o in rw.ops]:
        return {"aligned": False, "n_ops": [len(rf.ops), len(rw.ops)]}
    first = []
    for i, ((name, loc, df), (_, _, dw)) in enumerate(zip(rf.ops, rw.ops)):
        for a, b in zip(df, dw):
            if a is None or b is None or a[0] != b[0]:
                continue
            bad = (a[1] != b[1]).nonzero().flatten()
            if bad.numel():
                first.append({"op": i, "name": name, "at": loc,
                              "shape": [n, *a[0]],
                              "rows_differing": bad.tolist()})
                break
        if len(first) == 12:
            break
    out = {"aligned": True, "n_ops": len(rf.ops), "first_differing": first}
    if first:
        k = first[0]["op"]
        with torch.no_grad():
            with Recorder(rows_full, lo, n, keep=k) as rf:
                run_full()
            with Recorder(rows_win, 0, n, keep=k) as rw:
                run_win()
        (inf, outf), (inw, outw) = rf.kept, rw.kept

        def rows(t, rows_n, at):
            return t[at:at + n] if t.dim() and t.shape[0] == rows_n else t

        out["first_inputs_equal"] = [
            equal_rows(rows(a, rows_full, lo), rows(b, rows_win, 0))
            for a, b in zip(inf, inw)]
        out["first_input_shapes"] = [[list(a.shape), list(b.shape)]
                                     for a, b in zip(inf, inw)]
        o1, o2 = rows(outf[0], rows_full, lo), rows(outw[0], rows_win, 0)
        if o1.is_floating_point():
            out["first_max_abs_diff"] = float((o1 - o2).abs().max())
    return out


def compare(tag, full, win, lo, n, report):
    """Fields of two dataclasses (or tensors) of the stage: the window's
    against the full batch's rows [lo, lo+n)."""
    if not isinstance(full, torch.Tensor):
        for f in dataclasses.fields(full):
            a = getattr(full, f.name)
            if a is not None:
                compare(f"{tag}.{f.name}", a, getattr(win, f.name), lo, n,
                        report)
        return
    for name, a, b in [(tag, full, win)]:
        a = a[lo:lo + n]
        same = equal_rows(a, b)
        entry = {"equal": same}
        if not same and a.shape == b.shape:
            rows = (bits(a) != bits(b)).any(-1).nonzero().flatten()
            entry["rows"] = (rows + lo).tolist()
            if a.is_floating_point():
                entry["max_abs_diff"] = float((a - b).abs().max())
        elif not same:
            entry["shapes"] = [list(a.shape), list(b.shape)]
        report[name] = entry


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seeds", type=int, default=256)
    ap.add_argument("--window", default="106:128")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--probes", type=int, default=0,
                    help="dp.PROBES_PER_CHUNK (0: the package's)")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("lane_local_probe: no CUDA device")
    sys.path.insert(0, HERE)
    from chip_smoke import smi_line

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import cilqr_tpu_torch as P
    from cilqr_tpu_torch import (corridor, dp, pipeline, scenario, solver)
    from cilqr_tpu_torch.batch import solve_batch

    if not os.path.abspath(P.__file__).startswith(root + os.sep):
        sys.exit(f"lane_local_probe: imported {P.__file__}, not {root}")
    if args.probes:
        dp.PROBES_PER_CHUNK = args.probes
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = args.device
    lo, hi = (int(v) for v in args.window.split(":"))
    n = hi - lo
    cfg = P.PlannerConfig()
    cl = scenario.make_centerline()
    barriers = scenario.build_road_barriers(cl)
    lane = pipeline.make_lane_tuple(barriers[1], barriers[2], cfg,
                                    np.float32)
    spec = scenario.analytic_road_spec(dtype=np.float32)
    f32 = torch.float32
    scns = scenario.make_scenario_batch(range(args.seeds), dtype=f32,
                                        device=dev)
    starts = torch.tensor([0.0, 0.0, 0.0, 10.0], dtype=f32,
                          device=dev).repeat(args.seeds, 1)
    wscn = scns.map(lambda a: a[lo:hi])
    wst = starts[lo:hi]
    rep = {"label": args.label, "root": root, "window": [lo, hi],
           "seeds": args.seeds, "device": dev,
           "card": smi_line() if dev == "cuda" else "cpu"}
    stages = {}

    compare("scenario", scns, scenario.make_scenario_batch(
        range(lo, hi), dtype=f32, device=dev), lo, n, stages)

    def dp_run(s, st):
        return dp.plan(s, st[:, 0], st[:, 1], st[:, 2], cfg, None,
                       spec=spec)

    d_full = dp_run(scns, starts)
    d_win = dp_run(wscn, wst)
    compare("dp.traj", d_full.traj, d_win.traj, lo, n, stages)
    for f in ("ok", "min_cost", "sel_s", "sel_l"):
        compare(f"dp.{f}", getattr(d_full, f), getattr(d_win, f), lo, n,
                stages)

    # from here each stage takes the full batch's rows as the window's
    # inputs, so that a stage is compared alone
    traj_w = d_full.traj.map(lambda a: a[lo:hi])
    c_full = corridor.plan_corridors(scns, d_full.traj, cfg.corridor, lane)
    c_win = corridor.plan_corridors(wscn, traj_w, cfg.corridor, lane)
    compare("corridors", c_full, c_win, lo, n, stages)

    cons_full = pipeline.prep_constraints(c_full, cfg)
    cons_win = pipeline.prep_constraints(
        c_full.map(lambda a: a[lo:hi]), cfg)
    kc = cons_win.corridor_mask.shape[-1]
    s_w = cons_win.left_mask.shape[-1]
    rep["prep_widths"] = {"full": [cons_full.corridor_mask.shape[-1],
                                   cons_full.left_mask.shape[-1]],
                          "window": [kc, s_w]}
    # the window's trimmed constraints against the full batch's rows cut
    # to the window's slot widths; the full batch's extra slots must be
    # masked out on the window's rows
    for name in cons_full._fields:
        a = getattr(cons_full, name)[lo:hi]
        b = getattr(cons_win, name)
        d = 2 if name.startswith("corridor") else 1
        w = b.shape[d]
        same = equal_rows(a.narrow(d, 0, w), b)
        if name.endswith("mask"):
            same = same and not bool(a.narrow(d, w, a.shape[d] - w).any())
        stages[f"prep.{name}"] = {"equal": same}
    goals = pipeline.coarse_to_states(d_full.traj)
    s6 = pipeline.start_states(starts, goals.dtype)
    g_first = solver.transform_goals(goals, s6)
    xs0_f, us0_f = solver.iqr_init(g_first, cfg.ilqr, cfg.vehicle,
                                   cfg.delta_t)
    xs0_w, us0_w = solver.iqr_init(g_first[lo:hi], cfg.ilqr, cfg.vehicle,
                                   cfg.delta_t)
    compare("iqr_init.xs", xs0_f, xs0_w, lo, n, stages)
    compare("iqr_init.us", us0_f, us0_w, lo, n, stages)

    h_full = pipeline._recheck_solution(scns, xs0_f, cfg, spec)
    h_win = pipeline._recheck_solution(wscn, xs0_f[lo:hi], cfg, spec)
    compare("recheck", h_full, h_win, lo, n, stages)

    # the solve of the batch's first 128-lane block (an exit block of the
    # mega path) alone, from the full batch's problem; a rehearsal on
    # fewer than 256 scenarios takes half of them
    blk = 128 if args.seeds >= 256 else args.seeds // 2
    for backend in ("mega", "blast"):
        r_full = solve_batch(goals, s6, cons_full, cfg.ilqr, cfg.vehicle,
                             cfg.delta_t, backend=backend)
        r_win = solve_batch(goals[:blk], s6[:blk],
                            cons_full.map(lambda a: a[:blk]), cfg.ilqr,
                            cfg.vehicle, cfg.delta_t, backend=backend)
        for f in ("status", "iters", "xs", "us", "init_us"):
            compare(f"solve_{backend}.{f}", getattr(r_full, f),
                    getattr(r_win, f), 0, blk, stages)
    rep["stages"] = stages
    rep["stages_differing"] = [k for k, v in stages.items()
                               if v.get("equal") is False]

    # inside the DP: the chunk of the full batch that holds the window's
    # first row, against the window alone
    cells = cfg.dp.ns * cfg.dp.nl
    per_scn = min(max(1, cfg.dp.parent_chunk), cells) * cells * 16
    chunk = max(1, dp.PROBES_PER_CHUNK // per_scn)
    c0 = (lo // chunk) * chunk
    c1 = min(args.seeds, c0 + chunk)
    if hi > c1:
        sys.exit(f"window {lo}:{hi} spans two DP chunks of {chunk}")
    cscn = scns.map(lambda a: a[c0:c1])
    cst = starts[c0:c1]
    rep["dp_chunk"] = {"rows": [c0, c1], "width": c1 - c0, "window": n}

    def chunk_full():
        return dp._plan_chunk(cscn, cst[:, 0], cst[:, 1], cst[:, 2], cfg,
                              None, spec)

    def chunk_win():
        return dp._plan_chunk(wscn, wst[:, 0], wst[:, 1], wst[:, 2], cfg,
                              None, spec)

    rep["dp_ops"] = op_diff(chunk_full, chunk_win, c1 - c0, n, lo - c0, n)

    # the mechanism alone: the first w of 1,024 float32 rows [., 80]
    # summed by cumsum as a batch of w, against their sums in the batch of
    # 1,024
    g = torch.Generator().manual_seed(0)
    seg = torch.rand(1024, 80, generator=g).to(dev)
    ref = torch.cumsum(seg, -1)
    rep["cumsum_rows_equal_at_1024"] = {
        w: bool(torch.equal(torch.cumsum(seg[:w], -1), ref[:w]))
        for w in (1, 8, 22, 44, 64, 106, 128, 256, 512)}
    print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
