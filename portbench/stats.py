"""The benchmark's arithmetic: rates over a window, percentiles over every
sample, and the union of device intervals."""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work completed over the whole window, per second."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(samples, q: float) -> float:
    """The q-th percentile (0 < q < 100) of every sample, by linear
    interpolation between the closest ranks (numpy's default)."""
    xs = sorted(float(x) for x in samples)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge_intervals(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals) -> float:
    """Total length covered by the intervals, overlaps counted once."""
    return sum(b - a for a, b in merge_intervals(intervals))


def gaps(intervals, start: float, end: float):
    """The stretches of [start, end] that no interval covers, as (a, b)."""
    out, cur = [], start
    for a, b in merge_intervals(intervals):
        if b <= start or a >= end:
            continue
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < end:
        out.append((cur, end))
    return out
