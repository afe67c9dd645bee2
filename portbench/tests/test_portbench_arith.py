"""The benchmark's arithmetic: rate, p90 over every sample, idle
share by interval union, roofline operations and bytes, and the metric
readers."""

import numpy as np
import pytest
import torch

from portbench import registry, roofline, stats, trace
from portbench.run import Reading


def test_rate_and_percentiles():
    assert stats.rate(2048, 4.0) == 512.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    xs = np.random.default_rng(0).exponential(size=137)
    for q in (50, 90, 95):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile([3.0], 90) == 3.0


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(iv) == 4
    assert stats.gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert stats.gaps(iv, -1, 2) == [(-1, 0)]


def test_summarize_names_gaps_by_the_open_span():
    ev = [("plan_batch", 0.0, 100.0, False),
          ("dp", 0.0, 50.0, False),
          ("repair", 60.0, 100.0, False),
          ("k1", 5.0, 30.0, True),
          ("k2", 20.0, 40.0, True),
          ("mega_kernel<float>", 70.0, 90.0, True),
          ("k1", 95.0, 150.0, True)]
    s = trace.summarize(ev, {"plan_batch"}, {"dp", "repair"})
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((35 + 20 + 5) * 1e-6)
    assert s["kernel_s"]["mega_kernel<float>"] == pytest.approx(20e-6)
    assert s["kernel_s"]["k1"] == pytest.approx(30e-6)
    # a gap is named by the innermost range open where it begins
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert gaps == pytest.approx({"dp": 35e-6, "repair": 5e-6})
    assert s["device_ops"][0][0] == "k1"
    assert s["device_ops"][0][1] == pytest.approx(30e-6)


def test_roofline_matches_the_kernel_counts_of_chip_smoke():
    import chip_smoke

    N, KC, S, D, B, it = 81, 16, 40, 5, 1024, 7321
    assert roofline.solve_ops(B, it, N, KC, S, D) == chip_smoke.mega_ops(
        N, KC, S, D, B, it, it)
    nb = roofline.solve_bytes(B, N, KC, S, 4)
    T = N - 1
    want = B * 4 * (2 * N * 6 + 2 * T + 3 * N * KC + 14 * S) \
        + B * 4 * (6 * N + 2 * T + 6) + B * 16
    assert nb == want
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def _reading(**kw):
    base = dict(calls=4, span_s={"dp": 2.0, "repair": 1.0},
                missing=set(), main_iters=7.5,
                profile={"busy_s": 0.6, "window_s": 1.0,
                         "kernel_s": {"void mega_kernel<float>(x)": 0.5,
                                      "other": 0.1}},
                launches=[dict(lanes=1024, N=81, KC=16, S=40, D=5,
                               itemsize=4,
                               iters=torch.full((1024,), 8))])
    base.update(kw)
    return Reading(**base)


def test_metric_readers():
    r = _reading()
    assert registry.metric_reader("dp_ms.replan")(r) == 500.0
    assert registry.metric_reader("repair_ms.mpc")(r) == 250.0
    assert registry.metric_reader("corridors_ms.replan")(r) is None
    assert registry.metric_reader("dp_ms.replan")(
        _reading(missing={"dp"})) is None
    assert registry.metric_reader("iters_per_lane.mpc")(r) == 7.5
    assert registry.metric_reader("device_idle.replan")(r) == \
        pytest.approx(40.0)
    least = roofline.least_seconds(
        roofline.solve_ops(1024, 8 * 1024, 81, 16, 40, 5),
        roofline.solve_bytes(1024, 81, 16, 40, 4))
    assert registry.metric_reader("megasolve_roofline.replan")(r) == \
        pytest.approx(100 * least / 0.5)
    none = _reading(profile={"busy_s": 0, "window_s": 1.0,
                             "kernel_s": {"other": 1.0}})
    assert registry.metric_reader("megasolve_roofline.mpc")(none) is None


def test_failed_counts_lanes_without_a_plan():
    """``failed`` counts lanes whose plan is not finite; the planner's own
    flags (not converged, not ok, still dirty) are answers, counted apart."""
    from types import SimpleNamespace

    from portbench.kinds import mpc, replan

    xs, us = torch.zeros(4, 5, 4), torch.zeros(4, 4, 2)
    xs[1, 3, 0], us[2, 0, 1] = float("nan"), float("inf")
    final = SimpleNamespace(xs=xs, us=us,
                            status=torch.tensor([1, 4, 3, 5]))
    ok = torch.tensor([True, True, False, True])
    dirty = torch.tensor([True, False, False, False])
    parts = replan.outcome_parts(final, ok, dirty).tolist()
    assert parts == [2, 4, 2, 1, 1]
    win = {"outcome_parts": parts}
    assert replan.failed(win) == (2, {"unusable": 4, "not_converged": 2,
                                      "not_ok": 1, "still_dirty": 1})
    assert mpc.failed(win)[1]["corridor_failed"] == 1
