"""wide-deep [arXiv:1606.07792]: wide linear ∥ deep MLP, 40 sparse fields
(the reference's ``repro.configs.wide_deep``)."""

import dataclasses

from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register
from repro_torch.models.recsys.models import RecConfig

FULL = RecConfig(
    name="wide-deep",
    kind="wide_deep",
    n_dense=0,
    vocab_sizes=(100_000,) * 40,
    embed_dim=32,
    mlp_sizes=(1024, 512, 256),
)

SMOKE = dataclasses.replace(
    FULL, vocab_sizes=(64,) * 8, embed_dim=8, mlp_sizes=(32, 16),
)

register(
    ArchSpec(
        arch_id="wide-deep",
        family="recsys",
        config=FULL,
        smoke_config=SMOKE,
        shapes=dict(RECSYS_SHAPES),
        source="arXiv:1606.07792 (paper tier)",
        notes="wide tower = dim-1 embeddings (linear over one-hots).",
    )
)
