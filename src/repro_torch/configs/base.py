"""Architecture registry of the port: ``get_arch("llama3-8b")`` resolves a
dashed public id to an ``ArchSpec`` bundling the full-size config, the
reduced smoke config and the per-arch input-shape set.

A copy of the reference's ``repro.configs.base`` (same names, same
``LM_SHAPES`` and ``RECSYS_SHAPES``) that registers the configs the port
has ported: the five LM archs (llama3-8b, qwen3-1.7b, qwen1.5-110b, and
the MoE decoders kimi-k2-1t-a32b and llama4-maverick-400b-a17b) and the
four recsys archs (dlrm-mlperf, dcn-v2, wide-deep, dien).  The reference's
GNN arch (equiformer-v2) comes with a later slice (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
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
        kimi_k2_1t_a32b,
        llama3_8b,
        llama4_maverick_400b_a17b,
        qwen1_5_110b,
        qwen3_1_7b,
        wide_deep,
    )
