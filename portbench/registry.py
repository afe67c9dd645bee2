"""Finds everything a cell needs by name: its entry in BENCHMARK.json, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the module of the mix's kind
(``kinds/<kind>.py``), its limits (``limits/<cell>.json``) and the reader
of each per-layer metric (``metrics/<metric>.py``, or for a name with a
dot the reader its variants share, ``metrics/<stem>.py``, the name up to
the first dot). A new cell, mix,
configuration or metric is a new file and a new entry; no file is edited."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: pathlib.Path, name: str):
    """Import a source file by its path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # BENCHMARK.json entries this cell reports
    per_layer: list

    def kind(self):
        """The module of the traffic's kind, ``kinds/<kind>.py``."""
        return importlib.import_module(
            f"portbench.kinds.{self.traffic['kind']}")


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``: listed there, or
    listing no cells."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None, base: pathlib.Path = HERE
         ) -> Cell:
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg_file = ROOT / cfgs[w["config"]]["file"]
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    layers = [m for m in bench["per_layer"] if reports(m, name)]
    return Cell(name=name, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                config=load_json(cfg_file),
                traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(base / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layers)


def metric_reader(name: str, base: pathlib.Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``, or else of
    ``metrics/<stem>.py`` (``solve_ms.replan`` and ``solve_ms.mpc`` share
    ``solve_ms.py``)."""
    path = base / "metrics" / f"{name}.py"
    if not path.exists():
        path = base / "metrics" / f"{name.split('.')[0]}.py"
    mod = load_module(path, "portbench_metric_" + name.replace(".", "_"))
    return mod.read
