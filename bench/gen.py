"""Inputs made from ``--seed``: the corpus, the held-out query bank, the
insert stream's rows, and the insert stream's arrival gaps.

The vector generators are the distributions of ``sift_like`` and
``dssm_like`` (``repro_torch.data.synthetic``; ``chip_smoke.py::dssm_rows``
draws the latter on the card), drawn here on the device in chunks of
``CHUNK`` rows, each chunk from its own ``torch.Generator``.  The same seed
gives the same bytes on the same device; streams 0, 1 and 2 (corpus,
queries, inserts) share the modes or topics of one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.schedule import seed_of

CHUNK = 1 << 20  # rows a generator call
STREAM_CORPUS, STREAM_QUERIES, STREAM_INSERTS = 0, 1, 2


def _chunks(n: int, seed: int, stream: int, device):
    for i, off in enumerate(range(0, n, CHUNK)):
        g = torch.Generator(device=device)
        g.manual_seed(seed_of(seed, stream, i))
        yield off, min(CHUNK, n - off), g


def sift_like(n: int, dim: int, seed: int, stream: int, device):
    """Clustered non-negative rows around 64 gamma-drawn modes (SIFT's
    shape: dim 128, values in the tens).  Returns (rows, None)."""
    rng = np.random.default_rng(seed_of(seed, 0))
    centers = torch.from_numpy(
        rng.gamma(2.0, 20.0, size=(64, dim)).astype(np.float32)).to(device)
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for off, m, g in _chunks(n, seed, stream, device):
        a = torch.randint(0, 64, (m,), generator=g, device=device)
        x = centers[a] + 8.0 * torch.randn((m, dim), generator=g, device=device)
        out[off : off + m] = x.clamp_(min=0.0)
    return out, None


def dssm_like(n: int, dim: int, seed: int, stream: int, device):
    """Unit-norm rows around 256 normal topics (the paper's DSSM corpus).
    Returns (rows, topic of each row as uint8): the topic is the
    generator's own label, which the reference uses only to find quickly
    which rows cannot belong to a list it judges."""
    rng = np.random.default_rng(seed_of(seed, 0))
    topics = torch.from_numpy(
        rng.normal(size=(256, dim)).astype(np.float32)).to(device)
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    labels = torch.empty((n,), dtype=torch.uint8, device=device)
    for off, m, g in _chunks(n, seed, stream, device):
        a = torch.randint(0, 256, (m,), generator=g, device=device)
        x = topics[a] + 0.3 * torch.randn((m, dim), generator=g, device=device)
        out[off : off + m] = x / torch.linalg.norm(x, dim=1, keepdim=True)
        labels[off : off + m] = a.to(torch.uint8)
    return out, labels


GENERATORS = {"sift_like": sift_like, "dssm_like": dssm_like}


def draw(kind: str, n: int, dim: int, seed: int, stream: int, device):
    return GENERATORS[kind](n, dim, seed, stream, device)
