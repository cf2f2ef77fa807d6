"""llama3-8b [arXiv:2407.21783]: dense GQA decoder, 128k vocabulary (the
reference's ``repro.configs.llama3_8b``)."""

import dataclasses

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec, register
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="llama3-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=128256,
    rope_theta=500_000.0,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512, dtype=torch.float32,
)

register(
    ArchSpec(
        arch_id="llama3-8b",
        family="lm",
        config=FULL,
        smoke_config=SMOKE,
        shapes=dict(LM_SHAPES),
        source="arXiv:2407.21783 (unverified tier)",
        notes="long_500k skipped: pure full attention.",
    )
)
