"""``BENCHMARK.json`` holds to the benchmark's contract, and every entry
resolves by name to its files."""

from __future__ import annotations

import json
import re

import pytest

from bench.spec import load_cell, reader_path
from bench.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = load_cell(ROOT, cell)
    assert c.config["name"] == c.config_name
    assert c.end_to_end and c.per_layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    for m in c.end_to_end + c.per_layer:
        assert reader_path(ROOT, m["name"]).is_file(), m["name"]


def test_names_units_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m.get("workloads", []):
            cell = load_cell(ROOT, w)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}


def test_every_file_under_bench_is_named_from_name_characters():
    for p in (ROOT / "bench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
