"""Architecture registry of the port: ``get_arch("llama3-8b")`` resolves a
dashed public id to an ``ArchSpec`` bundling the full-size config, the
reduced smoke config and the per-arch input-shape set.

A copy of the reference's ``repro.configs.base`` (same names, same
``LM_SHAPES``, ``GNN_SHAPES`` and ``RECSYS_SHAPES``) that registers every
arch the reference registers: the five LM archs (llama3-8b, qwen3-1.7b,
qwen1.5-110b, and the MoE decoders kimi-k2-1t-a32b and
llama4-maverick-400b-a17b), the GNN arch (equiformer-v2) and the four
recsys archs (dlrm-mlperf, dcn-v2, wide-deep, dien).
"""

from __future__ import annotations

import dataclasses
from typing import Any

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
}

GNN_SHAPES = {
    "full_graph_sm": dict(
        kind="gnn_full", n_nodes=2708, n_edges=10556, d_feat=1433
    ),
    "minibatch_lg": dict(
        kind="gnn_sampled", n_nodes=232_965, n_edges=114_615_892,
        batch_nodes=1024, fanouts=(15, 10), d_feat=602,
        # padded block sizes consumed by the device step:
        max_nodes=170_000, max_edges=170_000,
    ),
    "ogb_products": dict(
        kind="gnn_full", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100
    ),
    "molecule": dict(
        kind="gnn_batched", n_nodes=30, n_edges=64, batch=128, d_feat=16
    ),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="rec_train", batch=65536),
    "serve_p99": dict(kind="rec_serve", batch=512),
    "serve_bulk": dict(kind="rec_serve", batch=262_144),
    "retrieval_cand": dict(kind="rec_retrieval", batch=1, n_candidates=1_000_000),
}


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str  # "lm" | "gnn" | "recsys"
    config: Any  # full-size config
    smoke_config: Any  # reduced config (CPU tests)
    shapes: dict
    source: str = ""  # public citation
    notes: str = ""


_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        dcn_v2,
        dien,
        dlrm_mlperf,
        equiformer_v2,
        kimi_k2_1t_a32b,
        llama3_8b,
        llama4_maverick_400b_a17b,
        qwen1_5_110b,
        qwen3_1_7b,
        wide_deep,
    )
