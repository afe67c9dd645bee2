"""The control: the reference in bfloat16 in the program's place comes out
not correct, while the program at the same size comes out correct (on
the CPU at a small size; on the card at the cell's own size through
``python3 -m portbench.calibrate``)."""

import json

import numpy as np
import pytest

from portbench import calibrate, compare

from . import small


@pytest.mark.parametrize("name", ["pedtest_spec.replan", "pedtest_spec.mpc"])
def test_control_is_not_correct(name, tmp_path):
    cell = small.cell(name)
    lines = []
    calibrate.readings(cell, [2**31 + 9], {2**31 + 9}, 0.0, device="cpu",
                       emit=lines.append, dump=tmp_path)
    got = {r["side"]: r for r in map(json.loads, lines)}
    keys = ("lanes_off", "step_residual", "cost_excess", "lanes_stalled")
    program = {k: got["program"][k] for k in keys}
    ctl = {k: got["control"][k] for k in keys}
    assert compare.verdict(program, cell.limits)[0], program
    assert not compare.verdict(ctl, cell.limits)[0], ctl
    assert ctl["step_residual"] > 10 * max(program["step_residual"], 1e-4)
    kept = np.load(tmp_path / f"{name}.program.none.{2**31 + 9}.npz")
    assert kept["excess"].shape == (cell.traffic["check_lanes"],)
    assert sorted(p.name.split(".")[2] for p in tmp_path.iterdir()) == [
        "control", "program"]
