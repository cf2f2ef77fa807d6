"""IVF search over the block pool: the ``union_fused`` path, and the
``union``, ``union_pallas``, ``block_table`` and ``chain_walk`` comparison
paths.

``union_fused`` runs in five steps:

1. the streaming coarse probe, ``coarse_topk`` (top-``nprobe`` centroids
   per query, ties to the lower centroid id);
2. the deduplicated candidate-block list, ``_union_candidates``: the union
   of the probed chains over the batch, so a block is a candidate once per
   batch, and the owner of every candidate;
3. the fused scan with a streaming top-K', which derives each query's
   membership from the candidate owners and its probe list, masks empty
   slots and tombstones, and returns packed pool locations
   ``block*T + offset``: ``ivf_block_topk`` over float32/bfloat16 blocks,
   ``ivf_block_topk_int8`` over int8 residual codes (the per-probe query
   residuals are quantized once per batch), ``ivf_pq_block_topk`` over PQ
   codes (one ADC table per query and probe, built once per batch);
4. with ``rerank=True``, the exact re-rank epilogue ``rerank_topk`` over
   the gathered K' survivor rows (int8 and PQ rows are reconstructed in
   float32, centroid included, first);
5. the final k-selection (the first k of the sorted K') and the resolution
   of locations to global ids.

Steps 1, 3 and 4 are kernels: on a CUDA tensor the hand-written Hopper
kernel, on a CPU tensor its plain PyTorch version (``kernels/ops.py``).
Path ``union_fused_scan`` runs the plain versions on any device; it is the
comparison the kernels are held to.

``block_table`` gathers every probed chain's blocks at once and
``chain_walk`` follows the ``next_block`` links one hop at a time; both
probe densely (``coarse_probe``) and score flat payloads in PyTorch and PQ
payloads through the ``score_fn`` hook (``core.pq.pq_score_fn``, whose
``use_kernel=True`` sums through the ``pq_adc`` kernel).  ``union`` and
``union_pallas`` take ``union_fused``'s candidate list but score it whole,
the full [C, Q, T] tensor (``ivf_block_scan``: its plain version on
``union``, the kernel by device on ``union_pallas``), then mask and select
k over C*T rows; they serve flat float32/bfloat16 payloads only.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import pq as pqmod
from repro_torch.core.block_pool import NULL, IVFState, PoolConfig
from repro_torch.kernels import ivf_scan, ops, ref

INF = float("inf")

# score_fn hooks have signature (state, queries, payload, probe_idx) ->
# [Q, C, T] scores; centroids and any other index-dependent data come from
# ``state`` (see core.pq.pq_score_fn).


def l2_sq(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] squared L2 distances."""
    qn = torch.sum(queries * queries, dim=-1, keepdim=True)
    pn = torch.sum(points * points, dim=-1)
    return qn + pn[None, :] - 2.0 * (queries @ points.T)


def _smallest(d: torch.Tensor, k: int):
    """(values, indices) of the k smallest per row; ties to the lower
    index, as ``jax.lax.top_k`` on the negated row, which also refuses a k
    above the row's length."""
    if k > d.shape[1]:
        raise ValueError(f"k {k} exceeds the {d.shape[1]} entries of a row")
    srt, idx = torch.sort(d, dim=1, stable=True)
    return srt[:, :k], idx[:, :k].to(torch.int32)


def coarse_probe(state: IVFState, queries: torch.Tensor, nprobe: int):
    """Top-``nprobe`` nearest centroids per query (dense formulation)."""
    d, idx = _smallest(l2_sq(queries, state.centroids), nprobe)
    return idx, d


def exact_search(corpus: torch.Tensor, queries: torch.Tensor, k: int):
    """Brute-force oracle used for recall metrics: (dists, ids)."""
    return _smallest(l2_sq(queries, corpus), k)


def gather_candidate_blocks(
    state: IVFState, probe_idx: torch.Tensor, chain_budget: Optional[int] = None
):
    """probe_idx [Q, nprobe] -> (payload [Q, C, T, ...], ids [Q, C, T],
    valid [Q, C, T]) over the first ``chain_budget`` blocks of every probed
    chain (C = nprobe * budget); NULL table slots read block 0 and are
    masked, as are empty slots and tombstones."""
    table = state.cluster_blocks
    if chain_budget is not None and chain_budget < table.shape[1]:
        table = table[:, :chain_budget]
    blocks = table[probe_idx.long()]  # [Q, nprobe, budget]
    flat = blocks.reshape(blocks.shape[0], -1)  # [Q, C]
    safe = torch.where(flat == NULL, 0, flat).long()
    payload = state.pool_payload[safe]
    ids = state.pool_ids[safe]
    # tombstoned rows keep a stale id until compaction: the live mask, not
    # id validity, decides whether a slot may score
    live = state.pool_live[safe] != 0
    valid = (flat != NULL)[..., None] & (ids != NULL) & live
    return payload, ids, valid


def flat_block_scores(queries: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """queries [Q, D], payload [Q, C, T, D] -> squared L2 [Q, C, T].  bf16
    payloads meet the query rounded to bf16 and are summed in float32, as
    the fused kernels do."""
    pf = payload.to(torch.float32)
    vn = torch.sum(pf * pf, dim=-1)
    qn = torch.sum(queries * queries, dim=-1)[:, None, None]
    qr = queries.to(payload.dtype).to(torch.float32)
    dots = torch.einsum("qd,qctd->qct", qr, pf)
    return qn + vn - 2.0 * dots


def _scores(state, queries, payload, probe_idx, score_fn):
    """[Q, C, T] scores of gathered blocks: raw vectors in PyTorch, codes
    through the payload's ``score_fn``."""
    if score_fn is None:
        return flat_block_scores(queries, payload)
    return score_fn(state, queries, payload, probe_idx)


def search_block_table(
    cfg: PoolConfig,
    state: IVFState,
    queries: torch.Tensor,
    *,
    nprobe: int,
    k: int,
    score_fn: Optional[Callable] = None,
    chain_budget: Optional[int] = None,
    pq=None,  # unused (PQ rides on score_fn here)
    rerank: bool = False,
):
    """Vectorised search over the gathered chains.  Returns (dists [Q, k],
    ids [Q, k]); ties go to the earlier candidate, as ``jax.lax.top_k``."""
    if rerank:
        raise NotImplementedError(
            "rerank is a fused-path epilogue; use union_fused[_scan]"
        )
    queries = queries.to(state.device, torch.float32).contiguous()
    probe_idx, _ = coarse_probe(state, queries, nprobe)
    payload, ids, valid = gather_candidate_blocks(state, probe_idx, chain_budget)
    scores = _scores(state, queries, payload, probe_idx, score_fn)
    scores = torch.where(valid, scores, INF)
    q = queries.shape[0]
    d, sel = _smallest(scores.reshape(q, -1), k)
    out_ids = torch.gather(ids.reshape(q, -1), 1, sel.long())
    return d, torch.where(torch.isinf(d), NULL, out_ids)


def search_chain_walk(
    cfg: PoolConfig,
    state: IVFState,
    queries: torch.Tensor,
    *,
    nprobe: int,
    k: int,
    score_fn: Optional[Callable] = None,
    chain_budget: Optional[int] = None,
    pq=None,  # unused (PQ rides on score_fn here)
    rerank: bool = False,
):
    """Follow the ``next_block`` links hop by hop (the paper's GPU
    traversal), merging each hop's rows into a running top-k; ties go to
    the earlier entry, as the reference's ``jax.lax.top_k`` over
    [best, hop]."""
    if rerank:
        raise NotImplementedError(
            "rerank is a fused-path epilogue; use union_fused[_scan]"
        )
    queries = queries.to(state.device, torch.float32).contiguous()
    q = queries.shape[0]
    probe_idx, _ = coarse_probe(state, queries, nprobe)
    cur = state.cluster_head[probe_idx.long()]  # [Q, nprobe]
    best_d = torch.full((q, k), INF, device=state.device)
    best_i = torch.full((q, k), NULL, dtype=torch.int32, device=state.device)
    for _ in range(chain_budget or cfg.max_chain):
        safe = torch.where(cur == NULL, 0, cur).long()
        payload = state.pool_payload[safe]  # [Q, nprobe, T, ...]
        ids = state.pool_ids[safe]  # [Q, nprobe, T]
        scores = _scores(state, queries, payload, probe_idx, score_fn)
        live = state.pool_live[safe] != 0
        alive = (cur != NULL)[..., None] & (ids != NULL) & live
        scores = torch.where(alive, scores, INF)
        cat_d = torch.cat([best_d, scores.reshape(q, -1)], dim=1)
        cat_i = torch.cat([best_i, ids.reshape(q, -1)], dim=1)
        best_d, sel = _smallest(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel.long())
        cur = torch.where(cur == NULL, NULL, state.next_block[safe])
    return best_d, torch.where(torch.isinf(best_d), NULL, best_i)


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


def search_union(
    cfg: PoolConfig,
    state: IVFState,
    queries: torch.Tensor,
    *,
    nprobe: int,
    k: int,
    score_fn: Optional[Callable] = None,  # unused (flat payload only)
    scan_impl: str = "plain",  # "plain" (union) | "kernel" (by device)
    chain_budget: Optional[int] = None,
    pq=None,  # unused (flat payload only)
    rerank: bool = False,
):
    """Score every row of the candidate blocks for every query, mask
    non-members, empty slots and tombstones to inf, and select the k
    smallest by (distance, candidate order): ties go to the lower block and
    offset, as ``jax.lax.top_k`` over the reference's ascending list.
    Returns (dists [Q, k], ids [Q, k]), ids -1 where the distance is inf."""
    if cfg.payload != "flat" or cfg.has_scales:
        raise NotImplementedError(
            "union/union_pallas score raw f32/bf16 vectors; PQ and int8 "
            "payloads use the fused union paths (or block_table/chain_walk "
            "for PQ)"
        )
    if rerank:
        raise NotImplementedError(
            "rerank is a fused-path epilogue; use union_fused[_scan]"
        )
    if scan_impl not in ("kernel", "plain"):
        raise ValueError(f"unknown scan_impl {scan_impl!r}")
    queries = queries.to(state.device, torch.float32).contiguous()
    q = queries.shape[0]
    p, t = state.pool_ids.shape
    uc = _union_candidates(cfg, state, queries, nprobe, chain_budget, scan_impl)
    scan = ops.ivf_block_scan if scan_impl == "kernel" else ref.ivf_block_scan_ref
    scores = scan(queries, state.pool_payload, uc.flat_blocks)  # [C, Q, T]
    blocks = uc.flat_blocks.long()  # live block ids, no NULL
    ids = state.pool_ids[blocks]  # [C, T]
    # tombstoned rows keep a stale id until compaction
    slot_ok = (ids != NULL) & (state.pool_live[blocks] != 0)  # [C, T]
    member = (uc.probe_idx[:, :, None] == uc.owners[None, None, :]).any(1)
    ok = member[:, :, None] & slot_ok[None]  # [Q, C, T]
    flat_d = torch.where(ok, scores.transpose(0, 1), INF).reshape(q, -1)
    flat_i = ids.reshape(1, -1).expand(q, -1)
    # the reference scores a static min(Q*NP*mc, P) candidates, NULL ones
    # masked to inf after the live ones: pad the (inf, NULL) tail as far
    # as k needs it, and refuse a k above that width as its top_k does
    mc = min(chain_budget or cfg.max_chain, cfg.max_chain)
    width = min(q * nprobe * mc, p) * t
    if k > width:
        raise ValueError(f"k {k} exceeds the {width} candidate rows of a query")
    short = k - flat_d.shape[1]
    if short > 0:
        flat_d = torch.nn.functional.pad(flat_d, (0, short), value=INF)
        flat_i = torch.nn.functional.pad(flat_i, (0, short), value=NULL)
    d, sel = _smallest(flat_d, k)
    out_ids = torch.gather(flat_i, 1, sel.long())
    return d, torch.where(torch.isinf(d), NULL, out_ids)


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
    int8 rows are residual codes, so the owning cluster's centroid is added
    back in float32 first and the rows go through the float32 re-rank.
    Returns ([Q, K'] dists asc, [Q, K'] locs)."""
    p, t = state.pool_ids.shape
    loc = _live_locs(state, loc).to(torch.int32).contiguous()
    safe = torch.clamp(loc, min=0).long()
    rows = state.pool_payload.reshape(p * t, -1)[safe]  # [Q, K', D]
    scales = torch.ones(loc.shape, dtype=torch.float32, device=loc.device)
    if cfg.has_scales:
        svs = state.pool_scales.reshape(-1)[safe]
        # free blocks own NULL: clamp for the gather (their locations are
        # already -1 and masked)
        owner = torch.clamp(state.block_owner[safe // t], min=0).long()
        rows = state.centroids[owner] + rows.to(torch.float32) * svs[..., None]
    rerank = ops.rerank_topk if scan_impl == "kernel" else ref.rerank_topk_ref
    return rerank(queries, rows, scales, loc)


def _rerank_pq(cfg, state, pq, queries, loc, scan_impl):
    """Re-rank PQ survivors at full precision: decode the codes, add the
    owning cluster's centroid back (residual semantics), then the float32
    re-rank.  Returns ([Q, K'] dists asc, [Q, K'] locs)."""
    p, t = state.pool_ids.shape
    loc = _live_locs(state, loc).to(torch.int32).contiguous()
    safe = torch.clamp(loc, min=0).long()
    codes = state.pool_payload.reshape(p * t, -1)[safe]  # [Q, K', M]
    owner = torch.clamp(state.block_owner[safe // t], min=0).long()
    recon = (state.centroids[owner] + pqmod.decode(pq, codes)).contiguous()
    ones = torch.ones(loc.shape, dtype=torch.float32, device=loc.device)
    rerank = ops.rerank_topk if scan_impl == "kernel" else ref.rerank_topk_ref
    return rerank(queries, recon, ones, loc)


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
    pq=None,  # PQParams, required for payload == "pq"
    rerank: bool = False,
):
    """Returns (dists [Q, k] ascending, ids [Q, k]); ids are -1 past the
    live candidates."""
    if cfg.payload == "pq" and pq is None:
        raise ValueError(
            "union_fused on a PQ payload needs the trained PQParams "
            "(pass pq=index.pq / via make_search_fn)"
        )
    if scan_impl not in ("kernel", "plain"):
        raise ValueError(f"unknown scan_impl {scan_impl!r}")
    queries = queries.to(state.device, torch.float32).contiguous()
    uc = _union_candidates(cfg, state, queries, nprobe, chain_budget, scan_impl)
    kp = kprime or default_kprime(k)
    if kp < k:
        raise ValueError(f"kprime {kp} < k {k}")
    if cfg.payload == "pq":
        # one ADC table per (query, probe), built once per batch
        lut = pqmod.probe_residual_luts(
            pq, state.centroids, queries, uc.probe_idx
        ).contiguous()  # [Q, NP, M, KSUB]
        topk = (ops.ivf_pq_block_topk if scan_impl == "kernel"
                else ref.ivf_pq_block_topk_ref)
        d, loc = topk(
            lut, state.pool_payload, uc.flat_blocks, uc.owners,
            state.pool_ids, state.pool_live, uc.probe_idx, kprime=kp,
        )
    elif cfg.has_scales:
        # int8 residual payload: quantize the per-probe query residuals
        # once, then score codes against codes
        qres = queries[:, None, :] - state.centroids[uc.probe_idx.long()]
        q_codes, q_meta = ivf_scan.quantize_queries(qres)  # [Q, NP, D], [Q, NP, 2]
        topk = (ops.ivf_block_topk_int8 if scan_impl == "kernel"
                else ref.ivf_block_topk_int8_ref)
        d, loc = topk(
            q_codes, q_meta, state.pool_payload, state.pool_scales,
            uc.flat_blocks, uc.owners, state.pool_ids, state.pool_live,
            uc.probe_idx, kprime=kp,
        )
    else:
        topk = (ops.ivf_block_topk if scan_impl == "kernel"
                else ref.ivf_block_topk_ref)
        d, loc = topk(
            queries, state.pool_payload, uc.flat_blocks, uc.owners,
            state.pool_ids, state.pool_live, uc.probe_idx, kprime=kp,
        )
    if rerank and cfg.payload == "pq":
        d, loc = _rerank_pq(cfg, state, pq, queries, loc, scan_impl)
    elif rerank:
        d, loc = _rerank_flat(cfg, state, queries, loc, scan_impl)
    # the K' rows are sorted ascending, so the k nearest are the first k
    d, loc = d[:, :k], loc[:, :k]
    out_ids = state.pool_ids.reshape(-1)[torch.clamp(loc, min=0).long()]
    out_ids = torch.where((loc == NULL) | torch.isinf(d), NULL, out_ids)
    return d, out_ids


# The reference's path names.
SEARCH_IMPLS = {
    "block_table": search_block_table,
    "chain_walk": search_chain_walk,
    "union": search_union,
    "union_pallas": partial(search_union, scan_impl="kernel"),
    "union_fused": search_union_fused,
    "union_fused_scan": partial(search_union_fused, scan_impl="plain"),
}
# the paths that can serve a PQ payload: block_table / chain_walk score
# through the score_fn hook, the fused union paths through the PQ-ADC
# streaming kernel; plain union / union_pallas score raw vectors only
PQ_SEARCH_PATHS = frozenset(
    {"block_table", "chain_walk", "union_fused", "union_fused_scan"}
)
# the fused union paths are the only ones that understand int8 payloads
# and the only ones with the re-rank epilogue
FUSED_SEARCH_PATHS = frozenset({"union_fused", "union_fused_scan"})
INT8_SEARCH_PATHS = FUSED_SEARCH_PATHS


def resolve_search_impl(
    cfg: PoolConfig, path: str, rerank: bool = False
) -> Callable:
    """Look up a scan path, rejecting typos and payload mismatches loudly
    (a silent fallback would serve the wrong path), by the reference's
    rules in the reference's order."""
    if path not in SEARCH_IMPLS:
        raise ValueError(
            f"unknown search_path {path!r}; expected one of "
            f"{sorted(SEARCH_IMPLS)}"
        )
    if cfg.payload == "pq" and path not in PQ_SEARCH_PATHS:
        raise NotImplementedError(
            f"search_path {path!r} scores raw vectors; PQ payloads support "
            f"{sorted(PQ_SEARCH_PATHS)}"
        )
    if cfg.has_scales and path not in INT8_SEARCH_PATHS:
        raise NotImplementedError(
            f"search_path {path!r} scores raw vectors; int8 payloads "
            f"support {sorted(INT8_SEARCH_PATHS)}"
        )
    if rerank and path not in FUSED_SEARCH_PATHS:
        raise NotImplementedError(
            f"rerank is a fused-path epilogue; search_path {path!r} does "
            f"not support it (use one of {sorted(FUSED_SEARCH_PATHS)})"
        )
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
    """Search step closed over (nprobe, k, path, score_fn, pq):
    ``step(state, queries)``."""
    impl = resolve_search_impl(cfg, path, rerank)

    def step(state: IVFState, queries: torch.Tensor):
        return impl(
            cfg, state, queries, nprobe=nprobe, k=k, score_fn=score_fn,
            chain_budget=chain_budget, pq=pq, rerank=rerank,
        )

    return step
