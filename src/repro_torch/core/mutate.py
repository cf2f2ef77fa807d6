"""Online mutations over the block pool: tombstone deletes and in-place
updates.

A delete cannot splice a row out of its chain (slot positions encode the
did arithmetic every insert relies on), so:

* ``delete`` clears the slot's bit in ``IVFState.pool_live`` (the ``[P, T]``
  tombstone mask every scan reads beside the payload) and the id's entry in
  ``id_map``: two scatters, O(batch) work, nothing else moves.  Compaction
  (``core.rearrange``) reclaims the slot later.
* ``update`` tombstones the old slot and inserts the fresh row under the
  same id in one step.  An id that is not resident becomes a plain insert
  (upsert), counted in ``num_missed``; a re-insert rejected at capacity
  leaves the tombstone and counts in ``num_dropped``.

As in ``core.insert``, the state's tensors are written in place and the
state is returned; every scatter the reference makes with ``mode="drop"``
selects its valid entries before writing, since PyTorch raises on an
out-of-range index.
"""

from __future__ import annotations

import torch

from repro_torch.core.block_pool import NULL, IVFState, PoolConfig
from repro_torch.core.insert import _put, assign_clusters, insert_payload, make_insert_fn


def _ids_and_valid(state: IVFState, ids, valid):
    ids = torch.as_tensor(ids).to(state.device, torch.int64)
    if valid is None:
        valid = torch.ones(ids.shape, dtype=torch.bool, device=state.device)
    return ids, torch.as_tensor(valid).to(state.device, torch.bool)


def _scatter_flags(order: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Flags computed in sorted order, put back in batch order."""
    out = torch.empty_like(flags)
    out[order] = flags
    return out


def last_occurrence_mask(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B] bool mask keeping only the last valid occurrence of each id: two
    refreshes of one row in a batch must not both come back live, so the
    last write wins, as if the updates were submitted a batch apart."""
    sid = torch.where(valid, ids.long(), NULL)
    order = torch.argsort(sid, stable=True)
    srt = sid[order]
    is_last = torch.ones_like(valid)
    is_last[:-1] = srt[:-1] != srt[1:]
    return valid & _scatter_flags(order, is_last)


def apply_delete(
    cfg: PoolConfig,
    state: IVFState,
    del_ids,  # [B] ids to tombstone (negative = padding)
    valid=None,  # [B] bool, ragged batches (padding)
    fence=None,
) -> IVFState:
    """Tombstone a batch of ids, in place.  ``fence()``, when given, is
    called right before the first write (see ``insert_payload``).

    Misses (ids never inserted, already deleted, past ``max_ids``, or
    repeated within the batch, where the first occurrence wins) count in
    ``num_missed`` and change nothing else."""
    del_ids, valid = _ids_and_valid(state, del_ids, valid)
    tm = cfg.block_size
    valid = valid & (del_ids >= 0)

    # first-occurrence dedup; invalid rows are keyed to -1 first so a
    # masked-out row never claims the first occurrence of a real id
    sid = torch.where(valid, del_ids, NULL)
    order = torch.argsort(sid, stable=True)
    srt = sid[order]
    first = torch.ones_like(valid)
    first[1:] = srt[1:] != srt[:-1]
    uniq = _scatter_flags(order, first)

    max_ids = state.id_map.shape[0]
    in_map = valid & uniq & (del_ids < max_ids)
    loc = state.id_map[torch.clamp(del_ids, 0, max_ids - 1)].long()
    loc = torch.where(in_map, loc, NULL)
    hit = in_map & (loc != NULL)
    sloc = torch.where(hit, loc, 0)
    blk, off = sloc // tm, sloc % tm

    if fence is not None:
        fence()
    _put(state.pool_live, hit, (blk, off), 0)
    _put(state.id_map, hit, del_ids, NULL)
    # the tombstoned slot's cluster accrues reclamation pressure (the
    # dead-fraction trigger of core.rearrange reads it)
    owner = state.block_owner[blk].long()
    dead_inc = torch.bincount(owner[hit], minlength=cfg.n_clusters)
    n_hit = hit.sum()
    state.dead_count.copy_(state.dead_count + dead_inc)
    state.num_vectors.copy_(state.num_vectors - n_hit)
    state.num_deleted.copy_(state.num_deleted + n_hit)
    state.num_missed.copy_(state.num_missed + (valid & ~hit).sum())
    return state


def make_delete_fn(cfg: PoolConfig):
    """Delete step: (state, ids[, valid]) -> state, written in place."""

    def step(state: IVFState, del_ids, valid=None):
        return apply_delete(cfg, state, del_ids, valid)

    return step


def make_update_fn(cfg: PoolConfig, encode=None):
    """Update step: tombstone + re-insert under the same id, one call.
    ``encode`` is ``make_insert_fn``'s hook (payload encoding of the raw
    rows)."""

    def step(state: IVFState, vectors, ids, valid=None):
        ids, valid = _ids_and_valid(state, ids, valid)
        vectors = torch.as_tensor(vectors, dtype=torch.float32).to(state.device)
        state = apply_delete(cfg, state, ids, valid)
        # duplicate targets within the batch: only the last write re-inserts
        keep = last_occurrence_mask(ids, valid)
        assign = assign_clusters(state.centroids, vectors)
        payload = vectors if encode is None else encode(state, assign, vectors)
        return insert_payload(cfg, state, assign, payload, ids, keep)

    return step


#: Mutation kinds a WAL record may carry, in their wire-format order (the
#: durability layer maps these to and from the record header's kind byte).
REPLAY_KINDS = ("insert", "delete", "update")


def make_replay_fns(cfg: PoolConfig, encode=None) -> dict:
    """Replay entry points for the durability layer: one batch step per
    mutation kind with the uniform signature ``(state, vectors, ids, valid)
    -> state`` (delete ignores ``vectors``), built from the same step
    constructors the online lane uses, so a replayed record goes through
    the same code as the original call."""
    insert_step = make_insert_fn(cfg, encode=encode)
    delete_step = make_delete_fn(cfg)
    update_step = make_update_fn(cfg, encode=encode)

    def _insert(state, vectors, ids, valid=None):
        return insert_step(state, vectors, ids, valid)

    def _delete(state, vectors, ids, valid=None):
        del vectors  # a delete record carries only ids
        return delete_step(state, ids, valid)

    def _update(state, vectors, ids, valid=None):
        return update_step(state, vectors, ids, valid)

    return {"insert": _insert, "delete": _delete, "update": _update}
