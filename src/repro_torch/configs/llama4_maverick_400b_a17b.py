"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4]: MoE 128e top-1.

Assignment config: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 128 experts top-1 (Switch-style routing).  The released model's early-
fusion multimodal frontend is a stub per the assignment (text backbone
only); all layers MoE (the release interleaves dense/MoE — noted).

A copy of the reference's ``repro.configs.llama4_maverick_400b_a17b``.
"""

import dataclasses

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec, register
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=0,
    vocab=202048,
    moe=True,
    n_experts=128,
    top_k=1,
    d_ff_expert=8192,
    capacity_factor=1.25,
    attn_chunk=512,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    n_experts=4, top_k=1, d_ff_expert=64, vocab=512, attn_chunk=16,
    dtype=torch.float32, remat=False,
)

register(
    ArchSpec(
        arch_id="llama4-maverick-400b-a17b",
        family="lm",
        config=FULL,
        smoke_config=SMOKE,
        shapes=dict(LM_SHAPES),
        source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified tier)",
        notes=(
            "modality frontend stubbed (text backbone only); top-1 routing; "
            "long_500k skipped (full attention)."
        ),
    )
)
