"""Memory-block based dynamic vector insertion (paper Alg. 2).

The paper's GPU kernel is thread-per-vector with two atomics:

* ``did = atomicAdd(nl_k, 1)`` — slot assignment inside the cluster;
* ``P[atomicAdd(cur_P, 1)]`` — lock-free block allocation when a thread
  crosses a block boundary (``moff == 0``).

This port keeps the reference's *deterministic* batch transform: a stable
sort by cluster gives every incoming vector its within-batch rank, so
``did = cluster_len[k] + rank`` reproduces the post-state of the atomic
protocol in batch order.  Everything is a handful of scatters into the
fixed-shape pool tensors, written in place: no copy of resident vectors,
no reallocation.

PyTorch raises on an out-of-range index where JAX's ``mode="drop"``
scatter silently drops it, so every scatter below selects its valid
entries explicitly before writing.
"""

from __future__ import annotations

import torch

from repro_torch.core.block_pool import (
    NULL,
    IVFState,
    PoolConfig,
    alloc_available,
    alloc_blocks,
    commit_alloc,
    quantize_int8,
)


def assign_clusters(centroids: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """k <- argmin_c ||y - c||^2  (Alg. 2 line 5); ties go to the lower id."""
    # ||y-c||^2 = ||y||^2 - 2 y.c + ||c||^2 ; ||y||^2 constant per row.
    dots = vectors @ centroids.T
    cn = torch.sum(centroids * centroids, dim=-1)
    return torch.argmin(cn[None, :] - 2.0 * dots, dim=-1).to(torch.int32)


def _put(dst: torch.Tensor, ok: torch.Tensor, idx, values) -> None:
    """``dst[idx][ok] = values[ok]`` — the scatter-with-drop of the
    reference, with the dropped entries removed before indexing."""
    if isinstance(idx, tuple):
        sel = tuple(i[ok] for i in idx)
    else:
        sel = (idx[ok],)
    if isinstance(values, torch.Tensor) and values.dim() > 0:
        values = values[ok]
    dst.index_put_(sel, torch.as_tensor(values, dtype=dst.dtype, device=dst.device))


def insert_payload(
    cfg: PoolConfig,
    state: IVFState,
    assign: torch.Tensor,  # [B] cluster of each new vector
    payload: torch.Tensor,  # [B, D] vectors | [B, M] u8 codes
    new_ids: torch.Tensor,  # [B] global ids
    valid: torch.Tensor | None = None,  # [B] bool — ragged batches (padding)
    fence=None,
) -> IVFState:
    """Insert a batch into the pool.  Updates ``state`` in place (the pool
    tensors are written, never copied or rebound) and returns it.

    ``fence()``, when given, is called once right before the first write
    to the state: everything before it (sort, ranks, allocation
    arithmetic) only reads the state, so the serving runtime can let it
    run beside a search and order only the writes after that search."""
    dev = state.device
    b = assign.shape[0]
    tm = cfg.block_size
    n_clusters, n_blocks, mc = cfg.n_clusters, cfg.n_blocks, cfg.max_chain
    assign = assign.to(dev, torch.int64)
    new_ids = new_ids.to(dev, torch.int64)
    if valid is None:
        valid = torch.ones((b,), dtype=torch.bool, device=dev)
    valid = valid.to(dev, torch.bool)
    # Padding rows are parked on cluster 0 but masked out of every scatter.
    assign = torch.where(valid, assign, 0)

    # Within-batch rank of each valid row inside its cluster: stable sort by
    # (assign, ~valid) so valid rows of a cluster precede padding.
    key = assign * 2 + (~valid).long()
    order = torch.argsort(key, stable=True)
    idx = torch.arange(b, dtype=torch.int64, device=dev)
    sorted_key = key[order]
    is_start = torch.ones((b,), dtype=torch.bool, device=dev)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - run_start

    # Hard per-cluster capacity: a chain holds max_chain * T_m vectors; rows
    # past it are rejected and counted (§3.3).  The filter removes the
    # highest ranks of a cluster, so surviving dids stay contiguous.
    old_len = state.cluster_len.long()
    cap_vecs = mc * tm
    pre_did = old_len[assign] + rank
    want = valid & (pre_did < cap_vecs)
    counts_want = torch.zeros(n_clusters, dtype=torch.int64, device=dev)
    counts_want.index_add_(0, assign, want.long())
    old_nblk = state.cluster_nblocks.long()
    want_nblk = (old_len + counts_want + tm - 1) // tm
    nblk_needed = want_nblk - old_nblk  # [N] >= 0 demanded new blocks
    cum = torch.cumsum(nblk_needed, dim=0)
    base = cum - nblk_needed  # exclusive cumsum: allocation rank base
    total_new = cum[-1]

    # Pool exhaustion: ranks are served free-stack-first then bump, so
    # failure is a suffix of [0, total_new); rows that would land in a
    # failed block are rejected (again a per-cluster rank suffix).
    succ_total = torch.minimum(total_new, alloc_available(state).long())
    succ_nblk = torch.minimum(
        torch.clamp(succ_total - base, min=0), nblk_needed
    )
    usable_cap = torch.clamp((old_nblk + succ_nblk) * tm, max=cap_vecs)
    vec_ok = want & (pre_did < usable_cap[assign])
    n_rejected = (valid & ~vec_ok).sum()
    valid = vec_ok
    counts = torch.zeros(n_clusters, dtype=torch.int64, device=dev)
    counts.index_add_(0, assign, valid.long())
    new_len = old_len + counts
    new_nblk = (new_len + tm - 1) // tm

    # ---- allocate new physical blocks (Alg. 2 lines 10-15) --------------
    # at most B new blocks per batch; enumerate candidate ranks j in [0, B)
    j = idx
    j_valid = j < total_new
    # cluster owning allocation rank j: searchsorted over inclusive cumsum
    owner = torch.searchsorted(cum, j, right=True)
    owner = torch.clamp(owner, 0, n_clusters - 1)
    jj = j - base[owner]  # index of this new block within its cluster's run
    phys = alloc_blocks(state, j, j_valid)  # NULL past pool capacity

    # quantize-on-insert (int8 flat payloads): rows are encoded once, as
    # residuals against their coarse centroid (Faiss IVF-SQ by_residual),
    # before the first write; resident data is never re-encoded or copied
    if cfg.has_scales:
        residuals = payload.to(dev, torch.float32) - state.centroids[assign]
        payload, scales = quantize_int8(residuals)
    if fence is not None:
        fence()

    # block-table scatter: cluster_blocks[owner, old_nblk[owner] + jj] = phys
    # (failed allocations would write NULL into NULL slots — skipped)
    tbl_cols = old_nblk[owner] + jj
    _put(state.cluster_blocks, j_valid & (tbl_cols < mc), (owner, tbl_cols),
         phys)

    # block -> owner map (the fused search's membership test reads it)
    granted = j_valid & (phys != NULL)
    _put(state.block_owner, granted, phys, owner)

    # linked-list relink (Alg. 2 line 14): the predecessor of run element
    # jj>0 is the phys of rank j-1; of jj==0 the old tail
    prev_same_run = alloc_blocks(state, j - 1, j_valid & (jj > 0))
    old_tail = state.cluster_tail.long()[owner]
    prev_blk = torch.where(jj > 0, prev_same_run, old_tail)
    _put(state.next_block, granted & (prev_blk != NULL), prev_blk, phys)

    # head/tail updates (only for blocks that were actually granted)
    first_valid = granted & (jj == 0) & (old_nblk[owner] == 0)
    last_valid = j_valid & (jj == succ_nblk[owner] - 1)
    _put(state.cluster_head, first_valid, owner, phys)
    _put(state.cluster_tail, last_valid, owner, phys)

    # ---- scatter the vectors themselves (Alg. 2 lines 6-8, 20) ----------
    did = old_len[assign] + rank
    mid = did // tm
    moff = did % tm
    vec_blk = state.cluster_blocks.long()[assign, torch.clamp(mid, 0, mc - 1)]
    rows_ok = valid & (vec_blk >= 0) & (vec_blk < n_blocks)
    if cfg.has_scales:
        _put(state.pool_scales, rows_ok, (vec_blk, moff), scales)
    _put(state.pool_payload, rows_ok, (vec_blk, moff),
         payload.to(dev, state.pool_payload.dtype))
    _put(state.pool_ids, rows_ok, (vec_blk, moff), new_ids)
    _put(state.pool_live, rows_ok, (vec_blk, moff), 1)
    # every accepted row's id maps to its packed pool location so
    # delete/update can find it (ids >= max_ids stay resident but unmapped)
    loc = vec_blk * tm + moff
    max_ids = state.id_map.shape[0]
    map_ok = valid & (new_ids >= 0) & (new_ids < max_ids)
    _put(state.id_map, map_ok, new_ids, loc)
    n_unmapped = (valid & ~map_ok).sum()

    state.cluster_nblocks.copy_(new_nblk)
    state.cluster_len.copy_(new_len)
    state.new_since_rearrange.copy_(state.new_since_rearrange + counts)
    state.num_vectors.copy_(state.num_vectors + valid.sum())
    state.num_dropped.copy_(state.num_dropped + n_rejected)
    state.num_unmapped.copy_(state.num_unmapped + n_unmapped)
    commit_alloc(state, succ_total)
    return state


def make_insert_fn(cfg: PoolConfig, encode=None):
    """End-to-end insert step: raw vectors -> updated state (in place).

    ``encode(state, assign, vectors) -> payload`` converts raw vectors to
    the pool payload (identity for ivfflat)."""

    def step(state: IVFState, vectors, new_ids, valid=None):
        vectors = torch.as_tensor(vectors, dtype=torch.float32).to(state.device)
        new_ids = torch.as_tensor(new_ids).to(state.device)
        assign = assign_clusters(state.centroids, vectors)
        payload = vectors if encode is None else encode(state, assign, vectors)
        return insert_payload(cfg, state, assign, payload, new_ids, valid)

    return step
