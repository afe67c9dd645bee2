"""BENCHMARK.json against the contract's limits: keys, names, units,
lengths, files, bounds and the cells' metrics."""

import json
import re

from portbench import registry

B = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(B)) <= 64 * 1024
    assert 1 <= len(B["command"]) <= 32 and all(line(w) for w in B["command"])
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_configs():
    used = {w["config"] for w in B["workloads"]}
    files = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith(B["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        data = registry.load_json(registry.ROOT / c["file"])
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
        assert len(c["reduced"]) <= 16


def test_workloads():
    pairs = set()
    names = {c["name"] for c in B["configs"]}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len({w["name"] for w in B["workloads"]}) == len(B["workloads"])
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, len(B["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells and registry.reports(e2e[m["moves"]], c)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in cells:
        got = [m["name"] for m in B["end_to_end"] if registry.reports(m, c)]
        assert "setup_s" in got and len(got) >= 2
        assert any(registry.reports(m, c) for m in B["per_layer"])


def test_files_are_named_from_names():
    for p in registry.HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(registry.ROOT).as_posix()
        assert PATH.match(rel), rel
