"""dlrm-mlperf [arXiv:1906.00091]: MLPerf DLRM benchmark config (Criteo 1TB)
(the reference's ``repro.configs.dlrm_mlperf``).

Embedding tables use the canonical Criteo-1TB per-field cardinalities
(~188M rows x 128 dims = 96 GB fp32), more than one card holds: a run on
one card caps each field's rows (``chip_smoke.py`` logs the cut).
"""

import dataclasses

from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register
from repro_torch.models.recsys.models import RecConfig

# Canonical MLPerf/Criteo-1TB cardinalities (26 sparse features)
CRITEO_1TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

FULL = RecConfig(
    name="dlrm-mlperf",
    kind="dlrm",
    n_dense=13,
    vocab_sizes=CRITEO_1TB_VOCABS,
    embed_dim=128,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
)

SMOKE = dataclasses.replace(
    FULL, vocab_sizes=(64,) * 26, embed_dim=8, bot_mlp=(16, 8),
    top_mlp=(32, 16, 1),
)

register(
    ArchSpec(
        arch_id="dlrm-mlperf",
        family="recsys",
        config=FULL,
        smoke_config=SMOKE,
        shapes=dict(RECSYS_SHAPES),
        source="arXiv:1906.00091 (paper tier); MLPerf Criteo-1TB vocab",
        notes="paper ANNS technique applies to retrieval_cand (IVF corpus).",
    )
)
