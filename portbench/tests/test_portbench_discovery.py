"""Every file a cell needs is found by its name, and a new cell, mix,
configuration or metric is added by files and entries alone."""

import json
import shutil

from portbench import registry


def test_every_cell_finds_its_files():
    b = registry.benchmark()
    for w in b["workloads"]:
        cell = registry.cell(w["name"], b)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["kind"] in ("replan", "mpc")
        assert hasattr(cell.kind(), "window")
        assert set(cell.limits) == {"lanes_off", "step_residual",
                                    "cost_excess", "lanes_stalled"}
        for m in cell.per_layer:
            assert callable(registry.metric_reader(m["name"]))


def test_configs_state_the_deployment():
    """Each configuration's file states the planner's parameters: the
    program and the reference build the same config from it, which is the
    reference's default (planner_config.h's values) but for the DP's
    collision test."""
    import dataclasses

    from cilqr_tpu_torch import config as P_config

    from portbench import inputs
    from portbench.ref import config as ref_config

    b = registry.benchmark()
    for c in b["configs"]:
        conf = registry.load_json(registry.ROOT / c["file"])
        planner = inputs.planner(conf)
        ref = ref_config.from_dict(planner)
        prog = P_config.from_dict(planner)
        assert dataclasses.asdict(prog) == dataclasses.asdict(ref)
        default = ref_config.PlannerConfig()
        dp = dataclasses.replace(default.dp, **planner["dp"])
        assert ref == dataclasses.replace(default, dp=dp)
        for key in ("delta_t", "tf", "vehicle", "ilqr", "corridor", "dp",
                    "repair"):
            assert key in planner, (c["name"], key)


def test_a_new_cell_by_files_alone(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(registry.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "traffic" / "replan_small.json").write_text(json.dumps(
        {"kind": "replan", "batch": 128, "perturb_y": 0.2,
         "check_lanes": 64}))
    (base / "limits" / "pedtest_spec.replan_small.json").write_text(
        json.dumps({"lanes_off": 0.0, "step_residual": 1.0,
                    "cost_excess": 1.0, "lanes_stalled": 0.0}))
    (base / "metrics" / "calls.replan_small.py").write_text(
        "def read(r):\n    return float(r.calls)\n")
    b = registry.benchmark()
    b["workloads"].append({"name": "pedtest_spec.replan_small",
                           "config": "pedtest_spec",
                           "traffic": "replan_small", "chips": 1,
                           "why": "a smaller batch"})
    b["per_layer"].append({"name": "calls.replan_small", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "replan entry",
                           "moves": "replans_per_s",
                           "workloads": ["pedtest_spec.replan_small"]})
    for m in b["end_to_end"]:
        if m["name"] == "replans_per_s":
            m["workloads"].append("pedtest_spec.replan_small")
    cell = registry.cell("pedtest_spec.replan_small", b, base=base)
    assert cell.traffic["batch"] == 128
    assert [m["name"] for m in cell.per_layer] == ["calls.replan_small"]
    assert registry.metric_reader("calls.replan_small", base)(
        type("R", (), {"calls": 3})()) == 3.0
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
