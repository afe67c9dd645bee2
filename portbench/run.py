"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with as many cards as the cell
asks for. Set-up (imports, CUDA, the kernels, the inputs, one warm-up of
the cell's shapes) is ``setup_s``; then the cell's traffic runs for
``--seconds`` seconds; then the program's state is freed and one call of
the window is compared with the plain reference (``compare``). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed`` (lanes returned without a finite plan), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics,
read in the window and in calls profiled after it), ``device``,
``outcomes`` (the planner's own flags over the window: unusable, not
converged, not ok, still dirty), with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit (also the last lines of
standard error). Without a card, or with fewer than the cell asks for, it
prints no result and exits 2; so it does when the program is not in the
checkout, and 4 when a forbidden module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

CALL_NAMES = frozenset({"plan_batch", "mpc_step_batch"})


class NotRunnable(RuntimeError):
    """The run cannot measure here: no card, or not enough."""


class Forbidden(RuntimeError):
    """A module that no run may load was loaded."""


def log(msg):
    print(msg, flush=True)


def power_limit():
    """nvidia-smi's name and power limit of the cards, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


@dataclasses.dataclass
class Reading:
    """What the per-layer metrics read: the window's span seconds and main
    solves, and the profiled calls' device summary and solve launches."""

    calls: int
    span_s: dict
    missing: set
    main_iters: float | None
    profile: dict
    launches: list


def _device(chips, device):
    import torch

    if device != "cuda":
        return device, {"platform": "cpu", "kind": "cpu", "count": 0}
    if not torch.cuda.is_available():
        raise NotRunnable("no CUDA device: the benchmark measures the card "
                          "and never falls back to the CPU")
    n = torch.cuda.device_count()
    if n < chips:
        raise NotRunnable(f"the cell asks for {chips} cards, {n} present")
    torch.cuda.init()
    return "cuda:0", {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": chips}


def _program(root: pathlib.Path):
    """Import the program and make sure it is the checkout's."""
    import cilqr_tpu_torch

    where = pathlib.Path(cilqr_tpu_torch.__file__).resolve().parent.parent
    if where != root:
        raise NotRunnable(f"cilqr_tpu_torch comes from {where}, not from the "
                          f"checkout {root}")
    return cilqr_tpu_torch


def per_layer(cell, rec, win, prof_summary):
    from portbench import registry

    iters = [t.double().mean() for t in rec.main_iters]
    r = Reading(calls=win["calls"],
                span_s=rec.span_seconds(), missing=rec.missing_spans(),
                main_iters=(float(sum(iters) / len(iters)) if iters
                            else None),
                profile=prof_summary, launches=list(rec.launches))
    out = {}
    for m in cell.per_layer:
        v = registry.metric_reader(m["name"])(r)
        if v is None:
            log(f"per-layer: {m['name']} has nothing to read in this cell")
            continue
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(workload, seed, seconds, trace, device="cuda", cell=None):
    """One run of a cell; returns the result's dict (``checks`` last).
    ``device`` "cpu" and a given ``cell`` serve the tests: the look for a
    card is skipped and the kernels' plain versions run."""
    import torch

    from portbench import compare, guard, registry, trace as trace_mod
    from portbench.recorder import Recorder

    cell = cell or registry.cell(workload)
    _program(registry.ROOT)
    dev, device_info = _device(cell.chips, device)
    log(f"device: {device_info}; nvidia-smi: {power_limit()}")
    log(f"set-up: imports and device init in "
        f"{time.perf_counter() - T_START:.3f} s")
    if dev.startswith("cuda"):
        from cilqr_tpu_torch.kernels import _build

        t = time.perf_counter()
        _build.library()
        log(f"set-up: kernel library {_build.library_path().name} loaded in "
            f"{time.perf_counter() - t:.3f} s")
    rec = Recorder().install()
    for span, name in rec.missing:
        log(f"spans: {name} is gone from the program; span {span!r} reads "
            f"as missing")
    mix = cell.kind()
    try:
        ctx = mix.setup(cell, seed, dev, log)
        setup_s = time.perf_counter() - T_START
        log(f"set-up: {setup_s:.3f} s in all")
        rec.timing = trace
        win = mix.window(ctx, seconds, rec, log)
        rec.timing = False
        lat_ms = [x * 1e3 for x in win["latencies"]]
        from portbench import stats

        log(f"window: {win['calls']} calls in {win['window_s']:.3f} s; call "
            f"latency median {stats.percentile(lat_ms, 50):.3f} ms, p90 "
            f"{stats.percentile(lat_ms, 90):.3f} ms, max {max(lat_ms):.3f} "
            f"ms over {len(lat_ms)} calls")
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.startswith("cuda") else 0)
        device_info["memory_peak_bytes"] = int(peak)
        n_failed, flags = mix.failed(win)
        log(f"failed (no plan returned): {n_failed} of {win['attempted']}; "
            f"the planner's flags: {flags}")
        result = {"correct": False, "attempted": int(win["attempted"]),
                  "failed": int(n_failed)}
        if trace:
            t = time.perf_counter()
            with trace_mod.capture() as prof:
                rec.profiling = True
                mix.profiled(ctx, rec)
                rec.profiling = False
            t_prof = time.perf_counter()
            names = CALL_NAMES | set(rec.spans)
            summary = trace_mod.summarize(trace_mod.events_of(prof, names),
                                          CALL_NAMES, set(rec.spans))
            log(f"trace: profiled calls in {t_prof - t:.3f} s, read in "
                f"{time.perf_counter() - t_prof:.3f} s; busy "
                f"{summary['busy_s']:.6f} s of {summary['window_s']:.6f} s")
            metrics = per_layer(cell, rec, win, summary)
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
            breakdown = {"device_ops": summary["device_ops"],
                         "idle_gaps": summary["idle_gaps"]}
        else:
            e2e = mix.end_to_end(win)
            e2e["setup_s"] = setup_s
            metrics = {m["name"]: {"value": e2e[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
            breakdown = None
    finally:
        rec.uninstall()
    keep = ("cell", "arrays", "starts", "seed", "device")
    ctx = {k: ctx[k] for k in keep}
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values, detail = mix.check(ctx, win, log)
    log(f"check: {detail}; reference in {time.perf_counter() - t:.3f} s")
    correct, checks = compare.verdict(values, cell.limits)
    bad = guard.loaded_forbidden()
    bad_ref = guard.reference_violations()
    if bad or bad_ref:
        raise Forbidden(f"forbidden modules: loaded {bad}; imported by the "
                        f"reference {bad_ref}")
    result.update(correct=correct, metrics=metrics, device=device_info,
                  outcomes=flags)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    except NotRunnable as e:
        print(f"not run: {e}", file=sys.stderr)
        return 2
    except Forbidden as e:
        print(str(e), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
