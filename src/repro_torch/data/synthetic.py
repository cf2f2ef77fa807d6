"""Deterministic synthetic vector corpora, shaped like the public datasets
they stand in for (SIFT1M 128-d, the paper's DSSM 64-d corpus).

Same generators as the JAX package's ``repro.data.synthetic``: numpy only,
so one seed gives the same bytes in both packages.
"""

from __future__ import annotations

import numpy as np


def sift_like(n: int, dim: int = 128, seed: int = 0, n_modes: int = 64):
    """Clustered float vectors resembling SIFT descriptors (non-negative)."""
    rng = np.random.default_rng(seed)
    centers = rng.gamma(2.0, 20.0, size=(n_modes, dim)).astype(np.float32)
    assign = rng.integers(0, n_modes, n)
    x = centers[assign] + rng.normal(0, 8.0, size=(n, dim)).astype(np.float32)
    return np.maximum(x, 0.0).astype(np.float32)


def dssm_like(n: int, dim: int = 64, seed: int = 1, n_topics: int = 256):
    """Normalised embedding-model vectors (the paper's industrial corpus)."""
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(n_topics, dim)).astype(np.float32)
    assign = rng.integers(0, n_topics, n)
    x = topics[assign] + 0.3 * rng.normal(size=(n, dim)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
