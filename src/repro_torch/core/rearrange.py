"""In-place rearrangement of fragmented block chains (paper Alg. 3, Fig. 1c),
which is also the reclamation path of the mutation lane.

The paper merges split memory blocks through a temporary segment so that a
chain's vectors become contiguous.  Here one cluster's chain is gathered
into a temp segment (a copy, made before any write), its dead rows are
dropped, and the live rows are written densely into a run of fresh blocks:
bump-allocated, so contiguous, while the bump region has room, else popped
off the free stack.  The old blocks go to the free stack, and the id map is
re-pointed at every moved row.  Two triggers feed the maintenance loop: the
paper's Exceed() insert statistic (Eq. 3) and a per-cluster dead fraction.

The reference gathers a fixed ``max_chain * T`` rows because XLA needs
static shapes; the port gathers the chain's own ``nblk * T`` rows, which
gives the same state.  It writes the state's tensors in place and decides
on the host whether a pass runs, where the reference selects the new state
under ``jnp.where(triggered, ...)``: a pass that triggers nothing leaves the
state untouched.
"""

from __future__ import annotations

import torch

from repro_torch.core.block_pool import NULL, IVFState, PoolConfig
from repro_torch.core.insert import _put


def exceed(state: IVFState, threshold: int) -> torch.Tensor:
    """Eq. 3: clusters whose newly inserted volume passed the threshold."""
    return state.new_since_rearrange > threshold


def rearrange_cluster(cfg: PoolConfig, state: IVFState, cluster: int) -> IVFState:
    """Compact one cluster's chain into fresh blocks, dropping tombstoned
    rows, in place.  An empty chain is a no-op.  Precondition (the fits
    mask of ``make_rearrange_fn``): the bump region fits the chain's length
    in blocks, or the free stack holds at least that many blocks."""
    tm, n_blocks = cfg.block_size, cfg.n_blocks
    dev = state.device
    k = int(cluster)
    nblk, cur_p, free_top = (
        torch.stack([state.cluster_nblocks[k], state.cur_p, state.free_top])
        .tolist()
    )
    table = state.cluster_blocks[k, :nblk].long()  # [nblk]

    # ---- temp segment: gather the whole chain (paper lines 7-9) ---------
    row_shape = tuple(state.pool_payload.shape[2:])
    tmp_payload = state.pool_payload[table].reshape((nblk * tm,) + row_shape)
    tmp_ids = state.pool_ids[table].reshape(-1)
    flat_live = (state.pool_live[table] != 0).reshape(-1)
    if cfg.has_scales:  # int8 dequant scales travel with their rows
        tmp_scales = state.pool_scales[table].reshape(-1)

    # ---- drop dead rows: stable partition, live rows first in chain order
    # (dids stay dense, so the slot arithmetic of future inserts holds)
    ordr = torch.argsort((~flat_live).to(torch.uint8), stable=True)
    n_live = int(flat_live.sum())
    new_nblk = -(-n_live // tm)

    # ---- a run of new_nblk fresh blocks -------------------------------
    # The reference tests the old chain length here, not new_nblk.
    bump_ok = cur_p + nblk <= n_blocks
    j = torch.arange(new_nblk, device=dev)
    if bump_ok:
        new_blocks = cur_p + j
    else:
        new_blocks = state.free_stack[
            torch.clamp(free_top - 1 - j, 0, n_blocks - 1)
        ].long()

    # dense rewrite (the "merge" of Alg. 3 lines 9-11): row r of the
    # compacted run lands in fresh block r // T at offset r % T; the tail of
    # the last block (r in [n_live, new_nblk*T)) takes the next rows of the
    # partition, which are dead, and is stamped empty
    r = torch.arange(new_nblk * tm, device=dev)
    sel = ordr[: new_nblk * tm]
    in_run = r < n_live
    row_r, off_r = new_blocks[r // tm], r % tm
    comp_ids = tmp_ids[sel]
    state.pool_payload[row_r, off_r] = tmp_payload[sel]
    state.pool_ids[row_r, off_r] = torch.where(in_run, comp_ids, NULL)
    state.pool_live[row_r, off_r] = in_run.to(torch.uint8)
    if cfg.has_scales:
        state.pool_scales[row_r, off_r] = tmp_scales[sel]
    # moved rows re-point their id-map entries at the fresh location
    max_ids = state.id_map.shape[0]
    map_ok = in_run & (comp_ids >= 0) & (comp_ids < max_ids)
    _put(state.id_map, map_ok, comp_ids.long(), row_r * tm + off_r)

    # ---- header and table updates (paper line 11) ----------------------
    if new_nblk:
        state.next_block[new_blocks[:-1]] = new_blocks[1:].to(torch.int32)
        state.next_block[new_blocks[-1]] = NULL
    state.cluster_blocks[k] = NULL
    state.cluster_blocks[k, :new_nblk] = new_blocks.to(torch.int32)
    state.cluster_head[k] = new_blocks[0] if new_nblk else NULL
    state.cluster_tail[k] = new_blocks[-1] if new_nblk else NULL

    # ---- free the old blocks (line 12) ----------------------------------
    # A free-stack run first pops its new_nblk blocks off the top; the nblk
    # pushes (nblk >= new_nblk) overwrite every popped position.  The old
    # blocks' ids, live bits, links and owner are cleared, so nothing stale
    # reaches a later scan.
    free_top -= 0 if bump_ok else new_nblk
    pos = free_top + torch.arange(nblk, device=dev)
    _put(state.free_stack, pos < n_blocks, pos, table)
    state.pool_ids[table] = NULL
    state.pool_live[table] = 0
    state.next_block[table] = NULL
    state.block_owner[new_blocks] = k
    state.block_owner[table] = NULL

    state.cluster_nblocks[k] = new_nblk
    state.cluster_len[k] = n_live
    state.dead_count[k] = 0
    state.new_since_rearrange[k] = 0
    state.free_top = torch.tensor(free_top + nblk, dtype=torch.int32, device=dev)
    state.cur_p = torch.tensor(cur_p + (new_nblk if bump_ok else 0),
                               dtype=torch.int32, device=dev)
    return state


def make_rearrange_fn(cfg: PoolConfig, threshold: int, dead_frac: float = 0.3):
    """Maintenance step: compact the single worst offender, if any; returns
    (state, triggered).  Callers loop while it triggers.

    A cluster is compactable when its run fits the bump region or the free
    stack holds enough blocks (``cluster_nblocks`` bounds the run, since
    dropping tombstones only shrinks it).  Among those, any cluster whose
    tombstoned fraction reaches ``dead_frac`` (with at least one dead slot)
    comes first, worst absolute ``dead_count`` first; otherwise the
    cluster with the largest ``new_since_rearrange`` above ``threshold``.
    Ties go to the lower cluster id."""

    def step(state: IVFState):
        nblk = state.cluster_nblocks
        fits = (state.cur_p + nblk <= cfg.n_blocks) | (state.free_top >= nblk)
        frac = state.dead_count.float() / torch.clamp(state.cluster_len, min=1).float()
        dstat = torch.where(fits & (frac >= dead_frac), state.dead_count, -1)
        stat = torch.where(fits, state.new_since_rearrange, -1)
        worst_dead, worst_stat = torch.argmax(dstat), torch.argmax(stat)
        d_val, s_val, wd, ws = torch.stack(
            [dstat[worst_dead].long(), stat[worst_stat].long(), worst_dead,
             worst_stat]
        ).tolist()  # the trigger's one sync
        if d_val > 0:
            return rearrange_cluster(cfg, state, wd), True
        if s_val > threshold:
            return rearrange_cluster(cfg, state, ws), True
        return state, False

    return step
