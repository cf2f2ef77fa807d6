"""Roofline analysis of dry-run records (the reference's
``repro.launch.roofline``).

Three terms per (arch, shape, mesh), in seconds, per device:
  compute    = flops / PEAK_FLOPS
  memory     = bytes_accessed / HBM_BW
  collective = collective bytes / LINK_BW

The dry run's counts are per device already (the ops one rank runs on its
local shards).  The constants are one NVIDIA H100 SXM5 80GB's, from its
datasheet (dense rates, no sparsity, at its 700 W limit).
``collective_bytes`` stands where the reference parsed HLO: it sums the
collectives a traced DTensor program issued.
"""

from __future__ import annotations

import json
from collections import defaultdict

# NVIDIA H100 SXM5 80GB datasheet
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s per GPU
HBM_BW = 3.35e12  # HBM3 B/s per GPU
# one ConnectX-7 NDR 400 Gb/s NIC per GPU: both production meshes have axes
# that leave the 8-GPU NVLink domain, so the slowest link bounds them
LINK_BW = 50e9  # B/s per link

_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def collective_bytes(events) -> dict:
    """Per-kind byte totals and counts of the collectives a traced program
    issued: ``events`` is an iterable of (kind, output bytes), ``kind``
    one of the reference's names ("all-gather", "all-reduce",
    "reduce-scatter", "all-to-all", "collective-permute").  Returns the
    reference's ``{"bytes": {...}, "counts": {...}}``."""
    out: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for kind, nbytes in events:
        if kind not in _KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] += nbytes
        counts[kind] += 1
    return {"bytes": dict(out), "counts": dict(counts)}


def roofline_terms(record: dict) -> dict:
    """record = one dryrun.py JSON line -> the three roofline terms."""
    chips = record["n_devices"]
    compute_s = record["flops"] / PEAK_FLOPS
    memory_s = record["bytes_accessed"] / HBM_BW
    coll_bytes = record.get(
        "collective_bytes_corrected",
        sum(record.get("collectives", {}).get("bytes", {}).values()),
    )
    collective_s = coll_bytes / LINK_BW
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1],
    )[0]
    out = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "collective_bytes": coll_bytes,
        "dominant": dominant,
        "bound_s": max(compute_s, memory_s, collective_s),
    }
    meta = record.get("meta", {})
    if meta.get("n_params"):
        n = meta["n_active"] if "n_active" in meta else meta["n_params"]
        factor = 6 if meta.get("backward") else 2
        model_flops = factor * n * meta["tokens"]  # global
        out["model_flops"] = model_flops
        flops_global = record["flops"] * chips
        out["useful_fraction"] = model_flops / flops_global if flops_global else 0.0
        # roofline fraction: useful model FLOP/s achieved at the bound
        out["roofline_fraction"] = (
            model_flops / chips / PEAK_FLOPS / out["bound_s"]
            if out["bound_s"] else 0.0
        )
    return out


def summarize(path: str) -> list[dict]:
    # keep the LAST record per (arch, shape, mesh): reruns supersede
    by_key: dict[tuple, dict] = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            by_key[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return [
        {**rec, **roofline_terms(rec)}
        for rec in sorted(
            by_key.values(), key=lambda r: (r["arch"], r["shape"], r["mesh"])
        )
    ]


def format_table(rows: list[dict]) -> str:
    hdr = (
        f"{'arch':<26}{'shape':<15}{'mesh':<9}{'compute_s':>11}"
        f"{'memory_s':>11}{'collect_s':>11}{'dominant':>11}{'useful%':>9}{'roof%':>7}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        uf = r.get("useful_fraction")
        rf = r.get("roofline_fraction")
        lines.append(
            f"{r['arch']:<26}{r['shape']:<15}{r['mesh']:<9}"
            f"{r['compute_s']:>11.2e}{r['memory_s']:>11.2e}"
            f"{r['collective_s']:>11.2e}{r['dominant']:>11}"
            f"{(f'{uf*100:.1f}' if uf is not None else '-'):>9}"
            f"{(f'{rf*100:.1f}' if rf is not None else '-'):>7}"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    rows = summarize(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.json")
    print(format_table(rows))
