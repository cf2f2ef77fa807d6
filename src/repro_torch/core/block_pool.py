"""Central memory pool split into fixed-size blocks (paper §3.1, Fig. 1b).

The paper pre-splits almost the entire GPU memory into blocks of ``T_m``
vectors and allocates them with a lock-free ``atomicAdd(cur_P)`` bump
pointer.  Here every tensor below has a fixed shape, allocated once by
``init_state``; "allocation" is index arithmetic on ``cur_p`` (plus a free
stack fed by rearrangement).  Every step (insert, delete, update,
compaction) writes into these tensors in place and never rebinds a field
to a new tensor — the paper's "no realloc, no copy" property, spelled
directly.  It also means a search queued on another CUDA stream keeps
reading live memory while a step runs, and a tensor's address never
changes.

Two chain representations are kept simultaneously:

* ``next_block`` — the paper-faithful linked list of block headers.
* ``cluster_blocks`` — a dense per-cluster *block table* that lets search
  gather an entire chain with one indexing operation.

Both are maintained by every mutation and checked against each other by
``check_invariants``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import numpy as np
import torch

NULL = -1  # null block pointer / empty id slot
_INV_127 = float(np.float32(1.0) / np.float32(127.0))

# admissible flat-payload dtypes: float32 is exact, bfloat16 halves and int8
# quarters the device bytes of the dominant scan loop.  int8 rows are
# symmetric per-vector quantized residuals (code = round(r / s),
# s = max|r| / 127) with the scale stored in ``IVFState.pool_scales``.
FLAT_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static geometry of the central pool."""

    n_clusters: int  # N  — number of IVF lists
    dim: int  # D  — raw vector dimensionality
    block_size: int  # T_m — vectors per memory block (paper uses 1024)
    n_blocks: int  # P  — blocks in the central pool
    max_chain: int  # longest admissible block chain per cluster
    payload: str = "flat"  # "flat" (raw vectors) | "pq" (codes)
    pq_m: int = 0  # number of PQ subquantizers (payload == "pq")
    dtype: Any = torch.float32  # flat payload dtype: float32 | bfloat16 | int8
    # capacity of the id -> pool-location map (0 = 2x the pool's slots)
    max_ids: int = 0

    def __post_init__(self):
        if self.max_ids <= 0:
            object.__setattr__(
                self, "max_ids", 2 * self.n_blocks * self.block_size
            )
        if self.payload not in ("flat", "pq"):
            raise ValueError(f"unknown payload {self.payload!r}")
        if self.payload == "pq" and self.pq_m <= 0:
            raise ValueError("pq payload requires pq_m > 0")
        if isinstance(self.dtype, str):
            if self.dtype not in FLAT_DTYPES:
                raise ValueError(
                    f"flat payload dtype must be one of "
                    f"{sorted(FLAT_DTYPES)}, got {self.dtype!r}"
                )
            object.__setattr__(self, "dtype", FLAT_DTYPES[self.dtype])
        if self.payload == "flat" and self.dtype not in FLAT_DTYPES.values():
            raise ValueError(
                f"flat payload dtype must be one of {sorted(FLAT_DTYPES)}, "
                f"got {self.dtype}"
            )

    def payload_shape(self) -> tuple:
        if self.payload == "flat":
            return (self.n_blocks, self.block_size, self.dim)
        return (self.n_blocks, self.block_size, self.pq_m)

    def payload_dtype(self):
        return self.dtype if self.payload == "flat" else torch.uint8

    @property
    def has_scales(self) -> bool:
        """int8 flat payloads carry a per-vector dequantization scale."""
        return self.payload == "flat" and self.dtype == torch.int8

    def scales_shape(self) -> tuple:
        # zero-size when unused, as in the reference's state layout
        if self.has_scales:
            return (self.n_blocks, self.block_size)
        return (0, 0)


@dataclasses.dataclass
class IVFState:
    """Dynamic pool + index state: fixed-shape tensors on one device.

    Same 23 fields, names, dtypes and shapes as the reference's
    ``repro.core.block_pool.IVFState``; scalars are 0-d int32 tensors."""

    centroids: torch.Tensor  # [N, D] f32 coarse quantizer
    pool_payload: torch.Tensor  # [P, T_m, D] vectors | [P, T_m, M] u8 codes
    pool_ids: torch.Tensor  # [P, T_m] i32 global ids, NULL = empty slot
    pool_scales: torch.Tensor  # [P, T_m] f32 int8 dequant scales ([0,0] unused)
    pool_live: torch.Tensor  # [P, T_m] u8 live mask: 1 = occupied & not deleted
    id_map: torch.Tensor  # [max_ids] i32 id -> packed location, NULL = absent
    block_owner: torch.Tensor  # [P] i32 owning cluster per block, NULL = free
    next_block: torch.Tensor  # [P] i32 linked-list next pointer
    cluster_head: torch.Tensor  # [N] i32 first block of each chain
    cluster_tail: torch.Tensor  # [N] i32 last block of each chain
    cluster_blocks: torch.Tensor  # [N, max_chain] i32 block table
    cluster_nblocks: torch.Tensor  # [N] i32 chain length
    cluster_len: torch.Tensor  # [N] i32 slots used per cluster (incl. tombstones)
    dead_count: torch.Tensor  # [N] i32 tombstoned slots awaiting compaction
    new_since_rearrange: torch.Tensor  # [N] i32 Exceed() statistic (Eq. 3)
    cur_p: torch.Tensor  # [] i32 bump pointer cur_P
    free_stack: torch.Tensor  # [P] i32 recycled block ids (top at free_top-1)
    free_top: torch.Tensor  # [] i32
    num_vectors: torch.Tensor  # [] i32 live vectors resident
    num_dropped: torch.Tensor  # [] i32 inserts rejected at capacity
    num_deleted: torch.Tensor  # [] i32 cumulative deletes/tombstones
    num_missed: torch.Tensor  # [] i32 delete/update targets not found
    num_unmapped: torch.Tensor  # [] i32 rows inserted with id >= max_ids

    @property
    def device(self) -> torch.device:
        return self.pool_ids.device


def init_state(
    cfg: PoolConfig,
    centroids: Union[np.ndarray, torch.Tensor],
    device: Union[str, torch.device, None] = None,
) -> IVFState:
    """Empty pool: nothing allocated, every chain empty.  ``device``
    defaults to the centroids' device for a tensor, else ``cuda``."""
    n, p, mc = cfg.n_clusters, cfg.n_blocks, cfg.max_chain
    if device is None:
        device = (
            centroids.device if isinstance(centroids, torch.Tensor) else "cuda"
        )
    if tuple(centroids.shape) != (n, cfg.dim):
        raise ValueError(
            f"centroids {tuple(centroids.shape)} != {(n, cfg.dim)} from config"
        )
    i32 = dict(dtype=torch.int32, device=device)

    def full(shape, value):
        return torch.full(shape, value, **i32)

    def zero():
        return torch.zeros((), **i32)

    return IVFState(
        # the coarse quantizer stays full precision regardless of the
        # payload dtype — quantization applies to pool rows, not centroids
        centroids=torch.as_tensor(centroids, dtype=torch.float32).to(device),
        pool_payload=torch.zeros(
            cfg.payload_shape(), dtype=cfg.payload_dtype(), device=device
        ),
        pool_ids=full((p, cfg.block_size), NULL),
        pool_scales=torch.zeros(
            cfg.scales_shape(), dtype=torch.float32, device=device
        ),
        pool_live=torch.zeros(
            (p, cfg.block_size), dtype=torch.uint8, device=device
        ),
        id_map=full((cfg.max_ids,), NULL),
        block_owner=full((p,), NULL),
        next_block=full((p,), NULL),
        cluster_head=full((n,), NULL),
        cluster_tail=full((n,), NULL),
        cluster_blocks=full((n, mc), NULL),
        cluster_nblocks=full((n,), 0),
        cluster_len=full((n,), 0),
        dead_count=full((n,), 0),
        new_since_rearrange=full((n,), 0),
        cur_p=zero(),
        free_stack=full((p,), NULL),
        free_top=zero(),
        num_vectors=zero(),
        num_dropped=zero(),
        num_deleted=zero(),
        num_missed=zero(),
        num_unmapped=zero(),
    )


def quantize_int8(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization: rows [..., D] f32 ->
    (codes [..., D] i8, scales [...] f32) with v ~= codes * scale.

    The scale floor keeps all-zero rows representable (codes 0, scale tiny)
    without a divide-by-zero.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  The scale is ``max|v|`` times the float32
    reciprocal of 127: the reference divides by 127, and XLA compiles
    that division by a constant into this product inside every jitted step
    that quantizes, so the reference's stored scales carry it."""
    scale = rows.abs().amax(dim=-1) * _INV_127
    scale = torch.clamp(scale, min=1e-30)
    codes = torch.clamp(torch.round(rows / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale.to(torch.float32)


def dequantize_int8(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """codes [..., D] i8, scales [...] f32 -> reconstructed rows f32."""
    return codes.to(torch.float32) * scales[..., None]


def alloc_blocks(
    state: IVFState, j: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Vectorised lock-free allocator (paper Alg. 2 line 13).

    ``j`` are allocation ranks 0..total_new-1 for this batch; rank j takes
    the j-th free-stack entry if available, else bump slot ``cur_p + spill``
    — a deterministic ``atomicAdd(cur_P, 1)`` per thread.  Returns physical
    block ids (int64), NULL where ``valid`` is False or the bump pointer
    would run off the pool."""
    n_blocks = state.free_stack.shape[0]
    free_top = state.free_top.long()
    from_free = j < free_top
    free_idx = torch.clamp(free_top - 1 - j, 0, n_blocks - 1)
    bump_idx = state.cur_p.long() + torch.clamp(j - free_top, min=0)
    phys = torch.where(from_free, state.free_stack[free_idx].long(), bump_idx)
    ok = valid & (from_free | (bump_idx < n_blocks))
    return torch.where(ok, phys, torch.full_like(phys, NULL))


def alloc_available(state: IVFState) -> torch.Tensor:
    """How many blocks the allocator can still hand out (free + bump)."""
    n_blocks = state.free_stack.shape[0]
    return state.free_top + torch.clamp(n_blocks - state.cur_p, min=0)


def commit_alloc(state: IVFState, total_new: torch.Tensor) -> None:
    """Post-allocation counter updates, written in place.  ``total_new``
    must be the count of successful allocations, so ``cur_p`` saturates at
    the pool size."""
    n_from_free = torch.minimum(total_new, state.free_top)
    state.cur_p.copy_(state.cur_p + (total_new - n_from_free))
    state.free_top.copy_(state.free_top - n_from_free)


def capacity_ok(state: IVFState, cfg: PoolConfig) -> bool:
    """True while the allocator can still hand out at least one block."""
    return bool((state.free_top > 0) | (state.cur_p < cfg.n_blocks))


def utilisation(state: IVFState, cfg: PoolConfig) -> float:
    """Fraction of pool slot capacity holding live vectors."""
    return int(state.num_vectors) / float(cfg.n_blocks * cfg.block_size)


def dead_fraction(state: IVFState) -> float:
    """Tombstoned fraction of all chain-resident slots."""
    used = max(int(state.cluster_len.sum()), 1)
    return int(state.dead_count.sum()) / float(used)


def pool_stats(state: IVFState, cfg: PoolConfig) -> dict:
    """Host-side gauge snapshot (one device sync for a handful of scalars)."""
    vals = torch.stack([
        state.cur_p.long(),
        state.free_top.long(),
        state.num_vectors.long(),
        state.num_dropped.long(),
        state.num_deleted.long(),
        state.num_missed.long(),
        state.num_unmapped.long(),
        state.dead_count.long().sum(),
        state.cluster_len.long().sum(),
    ]).tolist()
    (cur_p, free_top, live, dropped, deleted, missed, unmapped, dead,
     used) = vals
    return {
        "blocks_in_use": cur_p - free_top,
        "blocks_free": free_top + max(cfg.n_blocks - cur_p, 0),
        "utilisation": live / float(cfg.n_blocks * cfg.block_size),
        "dead_fraction": dead / max(used, 1),
        "live_vectors": live,
        "dead_slots": dead,
        "num_dropped": dropped,
        "num_deleted": deleted,
        "num_missed": missed,
        "num_unmapped": unmapped,
    }


# ---------------------------------------------------------------------------
# Host-side invariant checker (tests): walks the linked list with numpy and
# cross-checks the block table, chain lengths and slot validity.
# ---------------------------------------------------------------------------


def _host(state: IVFState) -> IVFState:
    """The state's integer leaves as numpy (the payload stays behind)."""
    return IVFState(**{
        f.name: (
            None if f.name in ("pool_payload", "centroids", "pool_scales")
            else getattr(state, f.name).cpu().numpy()
        )
        for f in dataclasses.fields(IVFState)
    })


def check_invariants(state: IVFState, cfg: PoolConfig) -> None:
    s = _host(state)
    seen_blocks: set[int] = set()
    for k in range(cfg.n_clusters):
        length = int(s.cluster_len[k])
        nblk = int(s.cluster_nblocks[k])
        expect_nblk = -(-length // cfg.block_size)  # ceil
        assert nblk == expect_nblk, (k, nblk, expect_nblk, length)
        chain = []
        cur = int(s.cluster_head[k])
        while cur != -1:
            assert cur not in seen_blocks, f"block {cur} in two chains"
            seen_blocks.add(cur)
            chain.append(cur)
            # every chained block knows its owner (the in-kernel membership
            # test of the fused scan rides on this invariant)
            assert int(s.block_owner[cur]) == k, (
                k, cur, int(s.block_owner[cur])
            )
            cur = int(s.next_block[cur])
            assert len(chain) <= cfg.max_chain, f"cluster {k} chain overflow"
        assert len(chain) == nblk, (k, chain, nblk)
        if nblk:
            assert int(s.cluster_tail[k]) == chain[-1]
        else:
            assert int(s.cluster_tail[k]) == -1
        table = [int(b) for b in s.cluster_blocks[k][:nblk]]
        assert table == chain, (k, table, chain)
        assert all(int(b) == -1 for b in s.cluster_blocks[k][nblk:])
        # block j holds dids [j*T, min(len, (j+1)*T)); tombstoned slots keep
        # their stale id but are dead in the live mask
        dead_k = 0
        for j, b in enumerate(chain):
            filled = min(length - j * cfg.block_size, cfg.block_size)
            ids = s.pool_ids[b]
            live = s.pool_live[b]
            assert (ids[:filled] >= 0).all(), (k, j, b, ids)
            assert (ids[filled:] == -1).all(), (k, j, b, ids)
            assert (live[filled:] == 0).all(), (k, j, b, live)
            for t in range(filled):
                vid = int(ids[t])
                loc = b * cfg.block_size + t
                if live[t]:
                    if vid < cfg.max_ids:
                        assert int(s.id_map[vid]) == loc, (
                            k, b, t, vid, int(s.id_map[vid]), loc
                        )
                else:
                    dead_k += 1
                    if vid < cfg.max_ids:
                        assert int(s.id_map[vid]) != loc, (k, b, t, vid)
        assert dead_k == int(s.dead_count[k]), (k, dead_k, int(s.dead_count[k]))
    assert int(s.num_vectors) == (
        int(s.cluster_len.sum()) - int(s.dead_count.sum())
    )
    for vid in np.flatnonzero(s.id_map != -1):
        loc = int(s.id_map[vid])
        b, t = loc // cfg.block_size, loc % cfg.block_size
        assert b in seen_blocks, (int(vid), loc)
        assert int(s.pool_ids[b, t]) == int(vid), (int(vid), loc)
        assert int(s.pool_live[b, t]) == 1, (int(vid), loc)
    free = {int(b) for b in s.free_stack[: int(s.free_top)]}
    assert not (free & seen_blocks), "freed block still chained"
    # unchained blocks own nothing and hold no live rows — a stale owner
    # would make the in-kernel membership test admit a dead block
    for b in range(s.block_owner.shape[0]):
        if b not in seen_blocks:
            assert int(s.block_owner[b]) == -1, (b, int(s.block_owner[b]))
            assert (s.pool_live[b] == 0).all(), b


def snapshot_ids(state: IVFState, cfg: PoolConfig) -> dict[int, list[int]]:
    """cluster -> ordered list of live vector ids (host-side test oracle)."""
    s = _host(state)
    out: dict[int, list[int]] = {}
    for k in range(cfg.n_clusters):
        ids: list[int] = []
        cur = int(s.cluster_head[k])
        while cur != -1:
            ids.extend(
                int(i)
                for i, lv in zip(s.pool_ids[cur], s.pool_live[cur])
                if int(i) != -1 and lv
            )
            cur = int(s.next_block[cur])
        out[k] = ids
    return out
