"""Seeded-bad trace: a tensor closed over by a step.

The closure captures the centroids as they were when the step was built,
so the step scores against that copy forever however the live state
moves, and a CUDA graph of it would freeze the address too.  The op
audit must flag ``baked-const``.
"""

import torch

FIXTURE_KIND = "trace"
EXPECT_RULES = ("baked-const",)


def build():
    # 16 KiB of f32: over the 4 KiB allowance
    centroids = torch.zeros(64, 64)

    def assign(queries):
        d = torch.cdist(queries, centroids)  # baked in, not an argument
        return torch.argmin(d, dim=1)

    return {
        "name": "fixture/baked_constant",
        "fn": assign,
        "args": (torch.randn(8, 64, generator=torch.Generator().manual_seed(0)),),
        "budget_bytes": 1 << 20,
    }
