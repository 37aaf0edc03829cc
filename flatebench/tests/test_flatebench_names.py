"""BENCHMARK.json against the benchmark's contract: every cell resolves to
its files by name, every metric has its reader, and every name, unit and
file name uses only the characters allowed."""
import json
import re

import pytest

from flatebench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["flatebench"]
    assert BENCH["command"] == ["python3", "flatebench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [m["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for m in BENCH[k]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.resolve(BENCH, cell)
    assert c.chips == 1
    assert (harness.BENCH / "ops" / f"{c.traffic['op']}.py").is_file()
    assert (harness.BENCH / "containers"
            / f"{c.config['container']}.py").is_file()
    assert (harness.BENCH / "reference"
            / f"{c.config['container']}.py").is_file()
    assert (harness.BENCH / "corpora"
            / f"{c.config['corpus']['generator']}.py").is_file()
    for m in c.end_to_end:
        assert harness.plugin("end_to_end", m["name"]).read
    for m in c.per_layer:
        assert harness.plugin("layer_metrics", m["name"]).read
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)


def test_names_units_and_entries():
    for w in BENCH["workloads"]:
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
        assert c["file"].startswith("flatebench/configs/")
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert all(k in cfg for k in c["reduced"])
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_files_under_the_folder_are_named_from_name_characters():
    for p in harness.BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
        assert len(rel) <= 200
