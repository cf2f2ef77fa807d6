"""A run at a size the CPU holds, through the plain paths: its last line
is the contract's object, with the numbers compared beside their limits."""

from __future__ import annotations

import json

import pytest

from bench import run
from bench.tests.tiny import make_root

SEED = 3_987_654_321  # more than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,trace", [("tiny.flat", False), ("tiny.flat", True),
                                        ("tiny.pq", False), ("tiny.search", False),
                                        ("tiny.search", True)])
def test_last_line_is_the_contract_object(root, cell, trace, capsys):
    res = run.run_cell(root, cell, SEED, 1.5, trace, device="cpu")
    run.emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert {"metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    names = set(line["metrics"])
    search = cell.endswith("search")
    if trace and search:
        assert {"search_rows_per_dispatch", "search_queue_wait_p50_ms",
                "search_latency_p95_ms"} <= names
    elif trace:
        assert names == {"mutation_ms_per_krow", "insert_ack_p95_ms",
                         "search_rows_per_s.mixed"}
    else:
        assert names == {"search_rows_per_s" if search else "insert_rows_per_s",
                         "setup_s"}
    assert (line["checks"]["kmeans_excess"]["value"]
            <= line["checks"]["kmeans_excess"]["limit"])
    assert all(m["value"] > 0 for m in line["metrics"].values())
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_refuses_without_a_card(capsys):
    assert run.main(["--workload", "sift1m-f32.mixed", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
