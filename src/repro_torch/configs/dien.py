"""dien [arXiv:1809.03672]: GRU interest extraction + AUGRU evolution (the
reference's ``repro.configs.dien``)."""

import dataclasses

from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register
from repro_torch.models.recsys.models import RecConfig

FULL = RecConfig(
    name="dien",
    kind="dien",
    n_dense=0,
    # field 0 = item vocab (shared by target + behaviour history)
    vocab_sizes=(1_000_000, 100_000, 10_000),
    embed_dim=18,
    mlp_sizes=(200, 80),
    seq_len=100,
    gru_dim=108,
)

SMOKE = dataclasses.replace(
    FULL, vocab_sizes=(128, 32, 16), embed_dim=8, mlp_sizes=(32, 16),
    seq_len=10, gru_dim=12,
)

register(
    ArchSpec(
        arch_id="dien",
        family="recsys",
        config=FULL,
        smoke_config=SMOKE,
        shapes=dict(RECSYS_SHAPES),
        source="arXiv:1809.03672 (unverified tier)",
        notes="seq_len=100 behaviour history; AUGRU attention gate.",
    )
)
