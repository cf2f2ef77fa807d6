"""The cell a run measures, found by name from ``BENCHMARK.json``.

A workload names a configuration and a traffic mix; each is a JSON file
found by name (``bench/configs/<config>.json``, ``bench/traffic/<mix>.json``),
and each per-layer metric is a reader ``bench/metrics/<metric>.py``.  A
later cell adds files and entries; nothing here changes for it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    root: Path  # the checkout: BENCHMARK.json and the program's src/
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries


# what the load generator implements; a mix asking for anything else is
# refused rather than run as something it is not
TRAFFIC_KINDS = {"search": {"loop": ("closed",)},
                 "insert": {"loop": ("open",), "arrivals": ("poisson",)}}


def check_traffic(name: str, traffic: dict) -> dict:
    for part, allowed in TRAFFIC_KINDS.items():
        for key, values in allowed.items():
            if part in traffic and traffic[part].get(key) not in values:
                raise ValueError(f"traffic {name}: {part}.{key} "
                                 f"{traffic[part].get(key)!r} is not one of {values}")
    if "search" not in traffic:
        raise ValueError(f"traffic {name}: no search part")
    return traffic


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The workload's entry, its configuration and traffic files, and the
    metrics it reports; raises ``KeyError`` for an unknown name and
    ``FileNotFoundError`` for a missing file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    traffic_file = root / "bench" / "traffic" / f"{entry['traffic']}.json"
    return Cell(
        root=root,
        name=workload,
        config_name=entry["config"],
        traffic_name=entry["traffic"],
        chips=entry["chips"],
        config=json.loads((root / config["file"]).read_text()),
        traffic=check_traffic(entry["traffic"], json.loads(traffic_file.read_text())),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def reader_path(root: Path, metric: str) -> Path:
    return root / "bench" / "metrics" / f"{metric}.py"
