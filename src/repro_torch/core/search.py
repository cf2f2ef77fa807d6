"""IVF search over the block pool: the ``union_fused`` path.

The search runs in five steps:

1. the streaming coarse probe, ``coarse_topk`` (top-``nprobe`` centroids
   per query, ties to the lower centroid id);
2. the deduplicated candidate-block list, ``_union_candidates``: the union
   of the probed chains over the batch, so a block is a candidate once per
   batch, and the owner of every candidate;
3. the fused scan with a streaming top-K' over float32/bfloat16 blocks,
   ``ivf_block_topk``, which derives each query's membership from the
   candidate owners and its probe list, masks empty slots and tombstones,
   and returns packed pool locations ``block*T + offset``;
4. with ``rerank=True``, the exact re-rank epilogue ``rerank_topk`` over
   the gathered K' survivor rows;
5. the final k-selection (the first k of the sorted K') and the resolution
   of locations to global ids.

Steps 1, 3 and 4 are kernels: on a CUDA tensor the hand-written Hopper
kernel, on a CPU tensor its plain PyTorch version (``kernels/ops.py``).
Path ``union_fused_scan`` runs the plain versions on any device; it is the
comparison the kernels are held to.  The reference's other paths
(``block_table``, ``chain_walk``, ``union``, ``union_pallas``) and the
int8 and PQ payloads are not ported yet and raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.block_pool import NULL, IVFState, PoolConfig
from repro_torch.kernels import ops, ref

INF = float("inf")

_LATER_PATHS = "ROADMAP queue 1, item 2 (the comparison search paths)"
_LATER_INT8 = "ROADMAP queue 1, item 3 (int8 payload search)"
_LATER_PQ = "ROADMAP queue 1, item 5 (PQ)"


def l2_sq(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] squared L2 distances."""
    qn = torch.sum(queries * queries, dim=-1, keepdim=True)
    pn = torch.sum(points * points, dim=-1)
    return qn + pn[None, :] - 2.0 * (queries @ points.T)


def _smallest(d: torch.Tensor, k: int):
    """(values, indices) of the k smallest per row; ties to the lower
    index, as ``jax.lax.top_k`` on the negated row."""
    srt, idx = torch.sort(d, dim=1, stable=True)
    return srt[:, :k], idx[:, :k].to(torch.int32)


def coarse_probe(state: IVFState, queries: torch.Tensor, nprobe: int):
    """Top-``nprobe`` nearest centroids per query (dense formulation)."""
    d, idx = _smallest(l2_sq(queries, state.centroids), nprobe)
    return idx, d


def exact_search(corpus: torch.Tensor, queries: torch.Tensor, k: int):
    """Brute-force oracle used for recall metrics: (dists, ids)."""
    return _smallest(l2_sq(queries, corpus), k)


class UnionCandidates(NamedTuple):
    flat_blocks: torch.Tensor  # [C] deduped live block ids, ascending
    owners: torch.Tensor  # [C] owning cluster per candidate
    probe_idx: torch.Tensor  # [Q, NP] probed cluster ids (distinct per row)


def _union_candidates(
    cfg: PoolConfig,
    state: IVFState,
    queries: torch.Tensor,
    nprobe: int,
    chain_budget: Optional[int],
    scan_impl: str = "kernel",
) -> UnionCandidates:
    """Routing prologue: coarse probe, then the union of the probed chains'
    blocks, deduplicated and ascending.  The reference pads this list with
    NULL to a static ``min(Q*NP*mc, P)`` for XLA; NULL candidates score
    nothing, so the port drops them and the results are the same."""
    mc = min(chain_budget or cfg.max_chain, cfg.max_chain)
    coarse = ops.coarse_topk if scan_impl == "kernel" else ref.coarse_topk_ref
    probe_idx, _ = coarse(queries, state.centroids, nprobe=nprobe)
    blocks = state.cluster_blocks[:, :mc][probe_idx.long()].reshape(-1)
    flat = torch.unique(blocks[blocks != NULL])  # sorted ascending
    owners = state.block_owner[flat.long()]
    return UnionCandidates(
        flat.to(torch.int32).contiguous(), owners.contiguous(),
        probe_idx.contiguous(),
    )


def default_kprime(k: int) -> int:
    """Accumulator width: smallest 128-multiple >= k (the reference's)."""
    return max(128, -(-k // 128) * 128)


def _live_locs(state: IVFState, loc: torch.Tensor) -> torch.Tensor:
    """Invalidate survivor locations whose slot is no longer live (defense
    in depth: the first pass already masks tombstones)."""
    live = state.pool_live.reshape(-1)[torch.clamp(loc, min=0).long()] != 0
    return torch.where((loc != NULL) & live, loc, NULL)


def _rerank_flat(cfg, state, queries, loc, scan_impl):
    """Exact-fp32 re-rank of flat-payload survivors: gather the K' rows by
    packed location, then dequant + distance + (distance, location) sort.
    Returns ([Q, K'] dists asc, [Q, K'] locs)."""
    p, t = state.pool_ids.shape
    loc = _live_locs(state, loc).to(torch.int32).contiguous()
    safe = torch.clamp(loc, min=0).long()
    rows = state.pool_payload.reshape(p * t, -1)[safe]  # [Q, K', D]
    scales = torch.ones(loc.shape, dtype=torch.float32, device=loc.device)
    rerank = ops.rerank_topk if scan_impl == "kernel" else ref.rerank_topk_ref
    return rerank(queries, rows, scales, loc)


def search_union_fused(
    cfg: PoolConfig,
    state: IVFState,
    queries: torch.Tensor,
    *,
    nprobe: int,
    k: int,
    score_fn: Optional[Callable] = None,  # unused (the fused path scores inline)
    scan_impl: str = "kernel",  # "kernel" (by device) | "plain"
    chain_budget: Optional[int] = None,
    kprime: Optional[int] = None,
    pq=None,  # unused until the PQ payload is ported
    rerank: bool = False,
):
    """Returns (dists [Q, k] ascending, ids [Q, k]); ids are -1 past the
    live candidates."""
    if cfg.payload == "pq":
        raise NotImplementedError(f"PQ payload search: {_LATER_PQ}")
    if cfg.has_scales:
        raise NotImplementedError(f"int8 payload search: {_LATER_INT8}")
    if scan_impl not in ("kernel", "plain"):
        raise ValueError(f"unknown scan_impl {scan_impl!r}")
    queries = queries.to(state.device, torch.float32).contiguous()
    uc = _union_candidates(cfg, state, queries, nprobe, chain_budget, scan_impl)
    kp = kprime or default_kprime(k)
    if kp < k:
        raise ValueError(f"kprime {kp} < k {k}")
    topk = ops.ivf_block_topk if scan_impl == "kernel" else ref.ivf_block_topk_ref
    d, loc = topk(
        queries, state.pool_payload, uc.flat_blocks, uc.owners,
        state.pool_ids, state.pool_live, uc.probe_idx, kprime=kp,
    )
    if rerank:
        d, loc = _rerank_flat(cfg, state, queries, loc, scan_impl)
    # the K' rows are sorted ascending, so the k nearest are the first k
    d, loc = d[:, :k], loc[:, :k]
    out_ids = state.pool_ids.reshape(-1)[torch.clamp(loc, min=0).long()]
    out_ids = torch.where((loc == NULL) | torch.isinf(d), NULL, out_ids)
    return d, out_ids


# The reference's path names.  ``None`` marks a path a later slice ports;
# resolving it raises instead of routing the search elsewhere.
SEARCH_IMPLS = {
    "block_table": None,
    "chain_walk": None,
    "union": None,
    "union_pallas": None,
    "union_fused": search_union_fused,
    "union_fused_scan": partial(search_union_fused, scan_impl="plain"),
}
FUSED_SEARCH_PATHS = frozenset({"union_fused", "union_fused_scan"})


def resolve_search_impl(
    cfg: PoolConfig, path: str, rerank: bool = False
) -> Callable:
    """Look up a scan path, rejecting typos, unported paths and payloads
    loudly (a silent fallback would serve the wrong path)."""
    if path not in SEARCH_IMPLS:
        raise ValueError(
            f"unknown search_path {path!r}; expected one of "
            f"{sorted(SEARCH_IMPLS)}"
        )
    if SEARCH_IMPLS[path] is None:
        raise NotImplementedError(
            f"search_path {path!r} is not ported yet: {_LATER_PATHS}; "
            f"use one of {sorted(FUSED_SEARCH_PATHS)}"
        )
    if cfg.payload == "pq":
        raise NotImplementedError(f"PQ payload search: {_LATER_PQ}")
    if cfg.has_scales:
        raise NotImplementedError(f"int8 payload search: {_LATER_INT8}")
    return SEARCH_IMPLS[path]


def make_search_fn(
    cfg: PoolConfig,
    *,
    nprobe: int,
    k: int,
    path: str = "block_table",
    score_fn: Optional[Callable] = None,
    chain_budget: Optional[int] = None,
    pq=None,
    rerank: bool = False,
):
    """Search step closed over (nprobe, k, path): ``step(state, queries)``."""
    impl = resolve_search_impl(cfg, path, rerank)

    def step(state: IVFState, queries: torch.Tensor):
        return impl(
            cfg, state, queries, nprobe=nprobe, k=k, score_fn=score_fn,
            chain_budget=chain_budget, pq=pq, rerank=rerank,
        )

    return step
