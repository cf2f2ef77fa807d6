"""A copy of the benchmark at a size the CPU runs in seconds: the SIFT1M
configuration with its scale cut, as a float32 and as a PQ index (with
re-rank, over rows that carry the generator's labels), under names of
their own, in a checkout of its own, with the cells of each kind of
traffic the harness knows: closed-loop search alone, and beside an
open-loop insert stream."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELLS = {"tiny.flat": "tiny-flat", "tiny.pq": "tiny-pq", "tiny.search": "tiny-flat"}
MIXED, SEARCH = "sift1m-f32.mixed", "sift1m-f32.search"


def _config(name: str, pq: bool) -> dict:
    c = json.loads((BENCH / "configs" / "sift1m-ivfflat-f32.json").read_text())
    c.update(name=name, n_rows=4000, dim=16, train_rows=4000, add_batch=1024)
    c["index"].update(n_clusters=32, dim=16, block_size=64, capacity_vectors=8000,
                      pool_blocks=32 + 8000 // 64 + 16, nprobe=4)
    c["runtime"]["nprobe"] = 4
    c["judge"].update(requests=8, self_check_every=5)
    if pq:
        c["corpus"] = "dssm_like"
        c["index"].update(payload="pq", pq_m=4, rerank=True)
        del c["index"]["dtype"]
        c["runtime"]["rerank"] = True
    return c


def make_root(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, pq in (("tiny-flat", False), ("tiny-pq", True)):
        (root / "bench" / "configs" / f"{name}.json").write_text(
            json.dumps(_config(name, pq)))
        bench["configs"].append({"name": name, "source": "tiny", "reduced": [],
                                 "file": f"bench/configs/{name}.json", "why": "tiny"})
    mix = {"search": {"loop": "closed", "clients": 4, "rows": 8, "max_client_rps": 400},
           "lead_in_s": 0.3, "query_batches": 32}
    (root / "bench" / "traffic" / "tiny-search.json").write_text(json.dumps(mix))
    mix["insert"] = {"loop": "open", "arrivals": "poisson", "rows": 4, "rate": 50}
    (root / "bench" / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    for cell, cfg in CELLS.items():
        bench["workloads"].append({
            "name": cell, "config": cfg, "chips": 1, "why": "tiny",
            "traffic": "tiny-search" if cell.endswith("search") else "tiny-mix"})
    # each tiny cell reports what the full cell of its kind reports
    for m in bench["end_to_end"] + bench["per_layer"]:
        if MIXED in m.get("workloads", []):
            m["workloads"] += ["tiny.flat", "tiny.pq"]
        if SEARCH in m.get("workloads", []):
            m["workloads"] += ["tiny.search"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
