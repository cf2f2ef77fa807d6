"""Seeded-bad trace: a host sync inside a step, at no allowed site.

``int(counts.max())`` makes the host wait for the card in the middle of
the step, and a boolean mask sizes its result on the host: neither can
be captured into a CUDA graph.  The op audit must flag ``host-sync``.
"""

import torch

FIXTURE_KIND = "trace"
EXPECT_RULES = ("host-sync",)


def build():
    def step(scores, counts):
        width = int(counts.max())  # a readback
        return scores[scores > 0][:width]  # a mask sized on the host

    g = torch.Generator().manual_seed(0)
    return {
        "name": "fixture/host_sync",
        "fn": step,
        "args": (torch.randn(64, 32, generator=g),
                 torch.randint(1, 9, (64,), generator=g)),
        "budget_bytes": 1 << 20,
    }
