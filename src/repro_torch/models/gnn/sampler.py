"""Fanout neighbour sampler for minibatch GNN training, GraphSAGE-style (the
reference's ``repro.models.gnn.sampler``, host numpy, the same draws from
the ``Generator`` in the same order: one seed gives the same padded block in
both packages).

Host-side (numpy) CSR sampling — the device step consumes fixed-shape padded
subgraphs.  This is the real component the ``minibatch_lg`` shape requires:
232 965 nodes / 114 M edges cannot be full-batched, so training samples
``batch_nodes`` seeds with fanouts (15, 10) and runs the equiformer on the
induced block graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E]
    n_nodes: int

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, n_nodes: int):
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, dst + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr=indptr, indices=src, n_nodes=n_nodes)

    def sample_neighbors(self, nodes: np.ndarray, fanout: int, rng):
        """Uniform sample up to ``fanout`` in-neighbours per node.

        Returns (src, dst) edge lists (padded stays absent — ragged here,
        fixed-shape padding happens in ``sample_block``)."""
        srcs, dsts = [], []
        for v in nodes:
            lo, hi = self.indptr[v], self.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            if deg <= fanout:
                nb = self.indices[lo:hi]
            else:
                nb = self.indices[lo + rng.integers(0, deg, fanout)]
            srcs.append(nb)
            dsts.append(np.full(len(nb), v, np.int64))
        if not srcs:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(srcs), np.concatenate(dsts)


def sample_block(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple,
    rng: np.random.Generator,
    max_nodes: int,
    max_edges: int,
):
    """Multi-hop sampled subgraph, padded to (max_nodes, max_edges).

    Returns dict with local edge index, node id mapping, and masks — the
    fixed shapes let one step's buffers serve every block.
    """
    nodes = list(seeds)
    node_set = {int(v): i for i, v in enumerate(seeds)}
    all_src, all_dst = [], []
    frontier = seeds
    for f in fanouts:
        src, dst = graph.sample_neighbors(frontier, f, rng)
        new = []
        for s in src:
            if int(s) not in node_set:
                node_set[int(s)] = len(nodes)
                nodes.append(int(s))
                new.append(int(s))
        all_src.append(src)
        all_dst.append(dst)
        frontier = np.asarray(new, np.int64)
        if len(frontier) == 0:
            break
    src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
    dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)
    # local ids
    lsrc = np.asarray([node_set[int(s)] for s in src], np.int64)
    ldst = np.asarray([node_set[int(d)] for d in dst], np.int64)
    nodes = np.asarray(nodes, np.int64)

    n, e = len(nodes), len(lsrc)
    n_keep = min(n, max_nodes)
    e_mask = (lsrc < n_keep) & (ldst < n_keep)
    lsrc, ldst = lsrc[e_mask][:max_edges], ldst[e_mask][:max_edges]
    e = len(lsrc)
    out_nodes = np.zeros(max_nodes, np.int64)
    out_nodes[:n_keep] = nodes[:n_keep]
    out_src = np.zeros(max_edges, np.int64)
    out_dst = np.full(max_edges, max_nodes, np.int64)  # pad -> dropped segment
    out_src[:e] = lsrc
    out_dst[:e] = ldst
    return {
        "node_ids": out_nodes,
        "n_nodes": n_keep,
        "edge_src": out_src.astype(np.int32),
        "edge_dst": out_dst.astype(np.int32),
        "n_edges": e,
        "seed_mask": np.arange(max_nodes) < len(seeds),
    }
