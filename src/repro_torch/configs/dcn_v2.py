"""dcn-v2 [arXiv:2008.13535]: cross network v2 ∥ deep MLP (Criteo) (the
reference's ``repro.configs.dcn_v2``)."""

import dataclasses

from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register
from repro_torch.models.recsys.models import RecConfig

# Criteo-Kaggle-scale hashed vocabularies (paper hashes to ~1e6 per field)
FULL = RecConfig(
    name="dcn-v2",
    kind="dcn_v2",
    n_dense=13,
    vocab_sizes=(1_000_000,) * 26,
    embed_dim=16,
    mlp_sizes=(1024, 1024, 512),
    n_cross_layers=3,
)

SMOKE = dataclasses.replace(
    FULL, vocab_sizes=(64,) * 26, embed_dim=8, mlp_sizes=(32, 16),
    n_cross_layers=2,
)

register(
    ArchSpec(
        arch_id="dcn-v2",
        family="recsys",
        config=FULL,
        smoke_config=SMOKE,
        shapes=dict(RECSYS_SHAPES),
        source="arXiv:2008.13535 (paper tier)",
        notes="hashed 1e6-row tables (paper's Criteo preprocessing).",
    )
)
