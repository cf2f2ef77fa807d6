"""qwen3-1.7b [hf:Qwen/Qwen3-8B family]: GQA with qk_norm, 152k vocab (the
reference's ``repro.configs.qwen3_1_7b``)."""

import dataclasses

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec, register
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="qwen3-1.7b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    attn_chunk=512,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512, attn_chunk=16, dtype=torch.float32, remat=False,
)

register(
    ArchSpec(
        arch_id="qwen3-1.7b",
        family="lm",
        config=FULL,
        smoke_config=SMOKE,
        shapes=dict(LM_SHAPES),
        source="hf:Qwen/Qwen3-8B (hf tier)",
        notes="qk_norm enabled; long_500k skipped (full attention).",
    )
)
