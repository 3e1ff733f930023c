"""BENCHMARK.json keeps to its contract, and every name in it resolves
to its files; a new configuration, mix, cell and metric are found
without an edit to any file that is there."""
import hashlib
import json
import re
import shutil

import pytest

from harness import bench

SPEC = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")


def test_contract_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and not c["reduced"]
        assert NAME.fullmatch(c["name"]) and LINE.fullmatch(c["source"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.fullmatch(w["why"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and LINE.fullmatch(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(name):
    cell = bench.resolve(name)
    assert cell.config and cell.limits and cell.end_to_end
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    kind = bench.kind_module(cell)
    assert callable(kind.run) and callable(kind.program_frame)
    for m in cell.per_layer:
        assert callable(bench.metric_reader(cell, m["name"]).read)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_without_edits(tmp_path):
    shutil.copytree(bench.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "brain-grid.json").read_text())
    (b / "configs" / "brain-fine.json").write_text(
        json.dumps({**conf, "cellsize": 0.07}))
    mix = json.loads((b / "traffic" / "gravity.json").read_text())
    (b / "traffic" / "long.json").write_text(
        json.dumps({**mix, "frames_per_episode": 60}))
    (b / "checks" / "brain-fine.long.json").write_text('{"fem_err": 0.1}')
    (b / "metrics" / "frames.traced.py").write_text(
        "def read(r):\n    return r.units\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "brain-fine", "source": "x",
                            "file": "benchmark/configs/brain-fine.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "brain-fine.long",
                              "config": "brain-fine", "traffic": "long",
                              "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "frames.traced", "unit": "frames",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "frame_ms",
                              "workloads": ["brain-fine.long"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = bench.resolve("brain-fine.long", root=tmp_path)
    assert cell.config["cellsize"] == 0.07
    assert cell.traffic["frames_per_episode"] == 60
    assert [m["name"] for m in cell.per_layer] == ["frames.traced"]
    assert bench.metric_reader(cell, "frames.traced").read(
        type("R", (), {"units": 3})()) == 3
    assert bench.kind_module(cell).__name__.startswith("bench_")
    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())
