"""Seeded-bad lint: wall clock and the global generator in replayed code.

``stamped`` is compiled and ``noisy`` is captured into a CUDA graph: their
host code runs once, so ``time.time()`` bakes one instant into every
replay and ``torch.randn`` without a generator freezes one draw.  The
linter must flag ``nondeterminism`` on both, and pass the keyed draw.
"""

import time

import torch

FIXTURE_KIND = "lint"
EXPECT_RULES = ("nondeterminism",)
EXPECT_LINES = (20, 26)


@torch.compile
def stamped(x):
    t = time.time()  # capture-time constant
    return x * t


def noisy(x, gen):
    keyed = torch.randn(x.shape, generator=gen)  # fine: keyed
    return x + torch.randn(x.shape) + keyed  # global generator


def capture(x, gen):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        noisy(x, gen)
    return g
