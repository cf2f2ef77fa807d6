"""Seeded-bad trace: a [C, Q, T]-class score materialization.

Scoring every probed block against every query in one op materializes an
8 MB tensor where a streaming path's budget is K'-row sized.  The op
audit must flag ``intermediate-bytes``.
"""

import torch

FIXTURE_KIND = "trace"
EXPECT_RULES = ("intermediate-bytes",)


def build():
    def scores(queries, blocks):
        # [C, Q, T] at once: C=256 blocks x Q=64 queries x T=128 slots
        s = torch.einsum("qd,ctd->cqt", queries, blocks)
        return s.amax(dim=(0, 2))

    g = torch.Generator().manual_seed(0)
    return {
        "name": "fixture/oversized_intermediate",
        "fn": scores,
        "args": (torch.randn(64, 64, generator=g),
                 torch.randn(256, 128, 64, generator=g)),
        # the K'-row budget a streaming path gets (2x Q*K' keys)
        "budget_bytes": 2 * 64 * 128 * 8,
    }
