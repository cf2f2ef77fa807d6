"""qwen1.5-110b [hf:Qwen/Qwen1.5 family]: dense GQA with QKV bias (the
reference's ``repro.configs.qwen1_5_110b``)."""

import dataclasses

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec, register
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="qwen1.5-110b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
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
        arch_id="qwen1.5-110b",
        family="lm",
        config=FULL,
        smoke_config=SMOKE,
        shapes=dict(LM_SHAPES),
        source="hf:Qwen/Qwen1.5-0.5B scaled per assignment (hf tier)",
        notes="QKV bias enabled; long_500k skipped (full attention).",
    )
)
