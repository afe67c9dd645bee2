"""Reading a ``torch.profiler`` capture of the profiled calls: the device's
busy time as the union of its intervals (overlapping work counted once),
the traced window, each kernel's device time, and the device's idle gaps,
each named by the innermost host range (a call or a span) open when it
began."""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

from . import stats


@contextlib.contextmanager
def capture():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def summarize(events, call_names, span_names, top: int = 10):
    """events: (name, start_us, end_us, on_device) tuples. The window runs
    from the first call's start to the last call's end (a call's range ends
    after its synchronise). Returns a dict of busy_s, window_s,
    kernel_s {name: seconds}, device_ops and idle_gaps (top lists of
    [name, seconds]; the gaps summed by the host range that was open)."""
    calls = [(a, b) for n, a, b, dev in events if not dev and n in call_names]
    if not calls:
        raise ValueError("the capture holds no call")
    w0, w1 = min(a for a, _ in calls), max(b for _, b in calls)
    dev = [(a, b) for _, a, b, d in events if d and b > w0 and a < w1]
    clipped = [(max(a, w0), min(b, w1)) for a, b in dev]
    busy_us = stats.union_length(clipped)
    kernel_us = defaultdict(float)
    for n, a, b, d in events:
        if d and b > w0 and a < w1:
            kernel_us[n] += min(b, w1) - max(a, w0)
    ranges = [(a, b, n) for n, a, b, d in events
              if not d and (n in call_names or n in span_names)]
    gap_us = defaultdict(float)
    for a, b in stats.gaps(dev, w0, w1):
        open_ = [(rb - ra, n) for ra, rb, n in ranges if ra <= a < rb]
        gap_us[min(open_)[1] if open_ else "host"] += b - a

    def top_list(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "kernel_s": {k: v / 1e6 for k, v in kernel_us.items()},
            "device_ops": top_list(kernel_us),
            "idle_gaps": top_list(gap_us)}


def events_of(prof, annotations=()):
    """(name, start_us, end_us, on_device) of every event of a capture. The
    profiler mirrors each ``record_function`` range onto the device's
    timeline as a user annotation; those are the host's ranges, not device
    work, and are dropped from it."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        dev = e.device_type == cuda
        if dev and (getattr(e, "is_user_annotation", False)
                    or e.name in annotations):
            continue
        out.append((e.name, e.time_range.start, e.time_range.end, dev))
    return out
