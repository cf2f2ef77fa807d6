"""Deterministic synthetic data, shaped like the public datasets it stands
in for: vector corpora (SIFT1M 128-d, the paper's DSSM 64-d corpus), the
LM trainer's token batches, the recsys models' click logs and the GNN
family's graphs (a power-law-ish graph with 3D positions, batched small
molecules).

Same generators as the JAX package's ``repro.data.synthetic``: numpy only,
so one seed gives the same bytes in both packages.
"""

from __future__ import annotations

from typing import Iterator

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


def token_stream(
    batch: int, seq: int, vocab: int, seed: int = 0, start_step: int = 0
) -> Iterator[dict]:
    """Zipf-distributed token batches; cursor = step (restart-replayable)."""
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        toks = rng.zipf(1.3, size=(batch, seq + 1)) % vocab
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "step": step,
        }
        step += 1


def click_stream(
    batch: int,
    n_dense: int,
    vocab_sizes,
    seed: int = 0,
    seq_len: int = 0,
    start_step: int = 0,
) -> Iterator[dict]:
    """Criteo-like click logs: lognormal dense + Zipf categorical ids."""
    vocab_sizes = np.asarray(vocab_sizes)
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        dense = rng.lognormal(0, 1, size=(batch, n_dense)).astype(np.float32)
        sparse = (rng.zipf(1.2, size=(batch, len(vocab_sizes))) - 1) % vocab_sizes
        out = {
            "dense": np.log1p(dense),
            "sparse": sparse.astype(np.int32),
            "label": (rng.random(batch) < 0.25).astype(np.float32),
            "step": step,
        }
        if seq_len:
            out["history"] = (
                (rng.zipf(1.2, size=(batch, seq_len)) - 1) % vocab_sizes[0]
            ).astype(np.int32)
        yield out
        step += 1


def random_graph(
    n_nodes: int, avg_degree: int, d_feat: int, seed: int = 0, n_classes: int = 16
):
    """Power-law-ish random graph with 3D positions + features."""
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    # preferential-attachment flavour: quadratic skew toward low ids
    src = (rng.random(n_edges) ** 2 * n_nodes).astype(np.int64)
    dst = rng.integers(0, n_nodes, n_edges)
    keep = src != dst  # no self loops (degenerate eSCN frames)
    return {
        "edge_src": src[keep].astype(np.int32),
        "edge_dst": dst[keep].astype(np.int32),
        "node_feat": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        "pos": rng.normal(size=(n_nodes, 3)).astype(np.float32),
        "label": rng.integers(0, n_classes, n_nodes).astype(np.int32),
    }


def molecule_batch(n_mols: int, nodes_per_mol: int, edges_per_mol: int, seed=0):
    """Batched small molecules (the ``molecule`` shape): graph regression."""
    rng = np.random.default_rng(seed)
    n = n_mols * nodes_per_mol
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    feat = rng.normal(size=(n, 16)).astype(np.float32)
    srcs, dsts = [], []
    for m in range(n_mols):
        base = m * nodes_per_mol
        s = rng.integers(0, nodes_per_mol, edges_per_mol)
        d = (s + 1 + rng.integers(0, nodes_per_mol - 1, edges_per_mol)) % nodes_per_mol
        srcs.append(base + s)
        dsts.append(base + d)
    graph_ids = np.repeat(np.arange(n_mols), nodes_per_mol)
    return {
        "node_feat": feat,
        "pos": pos,
        "edge_src": np.concatenate(srcs).astype(np.int32),
        "edge_dst": np.concatenate(dsts).astype(np.int32),
        "graph_ids": graph_ids.astype(np.int32),
        "n_graphs": n_mols,
        "target": rng.normal(size=(n_mols,)).astype(np.float32),
    }
