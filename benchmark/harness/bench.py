"""Find a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic
mix. The configuration's file is given in `configs`; the mix is
`benchmark/traffic/<traffic>.json`, and its "kind" names the runner
`benchmark/harness/kinds/<kind>.py`; the limits of the comparison that
decides `correct` are `benchmark/checks/<cell>.json`; each per-layer
metric is read by `benchmark/metrics/<metric>.py`. A new cell, mix,
configuration or metric is new files and entries, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # benchmark/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # metric entries this cell reports
    per_layer: list
    root: Path


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(name: str, bench_file: Path | None = None,
            root: Path | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    root = root or ROOT
    here = root / "benchmark"
    spec = json.loads((bench_file or root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "checks" / f"{name}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, root=root)


def kind_module(cell: Cell):
    return load_module(cell.root / "benchmark" / "harness" / "kinds"
                       / f"{cell.traffic['kind']}.py")


def metric_reader(cell: Cell, metric: str):
    return load_module(cell.root / "benchmark" / "metrics" / f"{metric}.py")
