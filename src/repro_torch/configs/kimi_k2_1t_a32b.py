"""kimi-k2-1t-a32b [arXiv:2501.kimi2]: trillion-param MoE, 384e top-8.

Assignment config: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
MoE 384 experts top-8.  All layers are MoE in this build (the released model
keeps layer 0 dense; uniform layers keep the scan homogeneous — noted).
Optimizer default for this scale is Adafactor.

A copy of the reference's ``repro.configs.kimi_k2_1t_a32b``.
"""

import dataclasses

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec, register
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,
    d_ff=0,
    vocab=163840,
    moe=True,
    n_experts=384,
    top_k=8,
    d_ff_expert=2048,
    capacity_factor=1.25,
    attn_chunk=512,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    n_experts=8, top_k=2, d_ff_expert=32, vocab=512, attn_chunk=16,
    dtype=torch.float32, remat=False,
)

register(
    ArchSpec(
        arch_id="kimi-k2-1t-a32b",
        family="lm",
        config=FULL,
        smoke_config=SMOKE,
        shapes=dict(LM_SHAPES),
        source="arXiv:2501.kimi2 paper-table (unverified tier)",
        notes=(
            "~1.03e12 total params; uniform MoE layers; adafactor default; "
            "long_500k skipped (full attention)."
        ),
    )
)
