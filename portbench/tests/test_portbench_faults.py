"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of the run is driven on
the CPU at a small size, once for each fault a cell can have (a step that
returns its state unchanged, on every lane or on one block of them; half
of the batch left out; an answer altered where it is produced; one card,
so no exchange between cards)."""

import dataclasses

import pytest

from portbench import calibrate, run

from . import small


def _broken_solve(orig, fault):
    def solve(*args, **kwargs):
        res = orig(*args, **kwargs)
        xs, us = res.xs.clone(), res.us.clone()
        if fault == "half":             # the second half never solved
            h = xs.shape[0] // 2
            xs[h:], us[h:] = 0.0, 0.0
        elif fault == "altered":        # one control changed on its way out
            us[0, 10, 0] += 5.0
        return dataclasses.replace(res, xs=xs, us=us)

    return solve


def _plant(monkeypatch, mod, fault):
    """unchanged: every solve hands back its guess; block: one lane of each
    launch does (at the card's size, ``calibrate.BLOCK`` lanes)."""
    if fault in ("unchanged", "block"):
        return calibrate.plant(fault, block=1)
    monkeypatch.setattr(mod, "solve_batch",
                        _broken_solve(mod.solve_batch, fault))
    return None


@pytest.mark.parametrize("fault", ["unchanged", "block", "half", "altered"])
def test_broken_replan_is_not_correct(monkeypatch, fault):
    from cilqr_tpu_torch import pipeline

    restore = _plant(monkeypatch, pipeline, fault)
    try:
        res = run.run("pedtest_spec.replan", 2**31 + 3, 0.0, False,
                      device="cpu", cell=small.cell("pedtest_spec.replan"))
    finally:
        if restore:
            restore()
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", ["carry", "unchanged", "block", "half",
                                   "altered"])
def test_broken_mpc_cycle_is_not_correct(monkeypatch, fault):
    from cilqr_tpu_torch import mpc

    restore = None
    if fault == "carry":               # the cycle hands its carry back
        orig = mpc.mpc_step_batch

        def step(scns, carry, *a, **k):
            _, out = orig(scns, carry, *a, **k)
            solve = dataclasses.replace(out.solve, xs=carry.xs, us=carry.us)
            return carry, dataclasses.replace(out, solve=solve)

        monkeypatch.setattr(mpc, "mpc_step_batch", step)
    else:
        restore = _plant(monkeypatch, mpc, fault)
    try:
        res = run.run("pedtest_spec.mpc", 2**31 + 4, 0.0, False,
                      device="cpu", cell=small.cell("pedtest_spec.mpc"))
    finally:
        if restore:
            restore()
    assert res["correct"] is False, res["checks"]
