"""User-facing IVFFlat / IVFPQ indexes over the block pool.

``IVFIndex`` owns the insert and search steps, the ``IVFState`` and, for
PQ payloads, the trained ``PQParams``.  The
offline segment (paper §3.3) is built by k-means and by replaying batched
inserts through the same insertion path the online segment uses — there is
no separate bulk loader.

The index runs on ``cuda`` unless the caller passes ``device="cpu"``; on a
machine without a GPU, ``IVFIndex(cfg)`` raises rather than quietly running
on the CPU.  Deletes, updates and compaction (Alg. 3) run through the same
state.  A PQ index encodes every row as the PQ code of its residual
against its centroid (insert and update alike) and searches through the
ADC tables of ``core.pq``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import pq as pqmod
from repro_torch.core.block_pool import IVFState, PoolConfig, init_state, pool_stats
from repro_torch.core.insert import make_insert_fn
from repro_torch.core.kmeans import kmeans
from repro_torch.core.mutate import make_delete_fn, make_update_fn
from repro_torch.core.rearrange import make_rearrange_fn
from repro_torch.core.search import make_search_fn

#: Version stamp of the (field set, field semantics) of ``IVFState`` as
#: serialized by ``state_to_host`` — the reference's schema, so a state
#: written by either package loads in the other.
STATE_SCHEMA_VERSION = 1


class StateSchemaError(RuntimeError):
    """A serialized IVFState does not match this build's schema."""


class StateChecksumError(RuntimeError):
    """A serialized IVFState leaf failed its per-leaf CRC32."""


def _leaf_crc(arr: np.ndarray) -> int:
    # the CRC of the leaf's C-ordered bytes, read in place (no copy)
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def state_to_host(state: IVFState) -> "tuple[dict[str, np.ndarray], dict]":
    """The whole state as ``{field: np.ndarray}`` plus a schema and
    per-leaf CRC32 meta dict (JSON-serializable) — the same layout as the
    reference's ``state_to_host``.  bfloat16 leaves are stored as their
    uint16 bit pattern; the logical dtype is recorded in the meta."""
    return host_meta(*host_copy(state))


def host_copy(state: IVFState) -> "tuple[dict[str, np.ndarray], dict]":
    """Each leaf copied to the host on the current stream (the copies wait
    for the stream's earlier work, and this call for the copies), plus
    each leaf's logical dtype.  From the card the copies land in pinned
    memory, several times faster than pageable (the caching host
    allocator keeps the buffers for the next copy).  The arrays never
    share memory with the live state, on a CPU index either, since the
    steps write the state in place.  bfloat16 leaves come back as their
    uint16 bit pattern."""
    pin = state.device.type == "cuda"
    arrays: dict[str, np.ndarray] = {}
    dtypes: dict[str, str] = {}
    for f in dataclasses.fields(IVFState):
        src = getattr(state, f.name).detach()
        t = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)
        t.copy_(src, non_blocking=pin)
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
            dtypes[f.name] = "bfloat16"
        else:
            arr = t.numpy()
            dtypes[f.name] = str(arr.dtype)
        arrays[f.name] = arr
    if pin:
        torch.cuda.current_stream(state.device).synchronize()
    return arrays, dtypes


def host_meta(
    arrays: "dict[str, np.ndarray]", dtypes: "dict[str, str]"
) -> "tuple[dict[str, np.ndarray], dict]":
    """``(arrays, meta)``: the schema and per-leaf CRC32 meta of
    ``host_copy``'s arrays, apart from the copy so a caller can checksum
    after releasing what it held for the copy."""
    fields = [f.name for f in dataclasses.fields(IVFState)]
    leaves = {
        name: {
            "crc32": _leaf_crc(arrays[name]),
            "dtype": dtypes[name],
            "shape": list(arrays[name].shape),
        }
        for name in fields
    }
    meta = {"schema": STATE_SCHEMA_VERSION, "fields": fields, "leaves": leaves}
    return arrays, meta


def state_from_host(
    arrays: "dict[str, np.ndarray]",
    meta: dict,
    *,
    verify: bool = True,
    device="cuda",
) -> IVFState:
    """Inverse of ``state_to_host`` (of either package): schema check,
    per-leaf CRC32 verify (``StateChecksumError`` names the bad leaf), then
    upload to ``device``."""
    if meta.get("schema") != STATE_SCHEMA_VERSION:
        raise StateSchemaError(
            f"snapshot schema {meta.get('schema')!r} != this build's "
            f"{STATE_SCHEMA_VERSION} — refusing to reinterpret leaves"
        )
    fields = [f.name for f in dataclasses.fields(IVFState)]
    if list(meta.get("fields", ())) != fields:
        raise StateSchemaError(f"snapshot fields {meta.get('fields')} != {fields}")
    dev: dict[str, torch.Tensor] = {}
    for name in fields:
        if name not in arrays:
            raise StateSchemaError(f"snapshot is missing leaf {name!r}")
        arr = np.asarray(arrays[name])
        info = meta["leaves"][name]
        if verify and _leaf_crc(arr) != info["crc32"]:
            raise StateChecksumError(
                f"leaf {name!r} failed its CRC32 — snapshot bytes are "
                "corrupt, refusing to serve from it"
            )
        if info["dtype"] == "bfloat16":  # uint16 bits -> int16 -> bfloat16
            arr = arr.view(np.int16)
        t = torch.from_numpy(np.array(arr, order="C"))  # writable copy, 0-d kept
        if info["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        dev[name] = t.to(device)
    return IVFState(**dev)


@dataclasses.dataclass
class IVFIndexConfig:
    n_clusters: int
    dim: int
    block_size: int = 1024  # paper deployment value T_m
    max_chain: int = 64
    pool_blocks: Optional[int] = None  # default: sized for capacity_vectors
    capacity_vectors: Optional[int] = None
    payload: str = "flat"  # "flat" | "pq"
    pq_m: int = 0
    dtype: str = "float32"  # flat payload dtype: float32 | bfloat16 | int8
    rerank: bool = False  # exact-fp32 re-rank epilogue (fused paths only)
    nprobe: int = 16
    k: int = 10
    rearrange_threshold: int = 10_000  # T'_m (paper Table 1 sweeps this)
    dead_frac_threshold: float = 0.3
    id_capacity: Optional[int] = None
    # the reference's path names (see core.search); "union" and
    # "union_pallas" are not ported yet and raise
    search_path: str = "block_table"
    # PQ on block_table / chain_walk: sum the ADC tables through the
    # pq_adc kernel (ops.pq_adc) instead of the plain adc_accumulate
    use_kernel: bool = False
    kmeans_iters: int = 10
    seed: int = 0

    def pool_config(self) -> PoolConfig:
        if self.pool_blocks is not None:
            n_blocks = self.pool_blocks
        else:
            cap = self.capacity_vectors or (self.n_clusters * self.block_size)
            # slack: every cluster may hold a partial tail block, plus 25%
            n_blocks = int(cap // self.block_size + self.n_clusters * 0.5 + 16)
        return PoolConfig(
            n_clusters=self.n_clusters,
            dim=self.dim,
            block_size=self.block_size,
            n_blocks=n_blocks,
            max_chain=self.max_chain,
            payload=self.payload,
            pq_m=self.pq_m,
            dtype=self.dtype,
            max_ids=self.id_capacity or 0,
        )


def _resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; without a GPU, asking for
    the default raises instead of quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the index runs on the GPU by "
                "default; pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


class IVFIndex:
    """IVFFlat (payload='flat') or IVFPQ (payload='pq') with online
    insertion over the block pool."""

    def __init__(self, cfg: IVFIndexConfig, *, device=None):
        self.cfg = cfg
        self.device = _resolve_device(device)
        self.pool_cfg = cfg.pool_config()
        self.pq: Optional[pqmod.PQParams] = None
        self.state: Optional[IVFState] = None
        self._insert_fn = None
        self._search_fns: dict = {}
        self._rearrange_fn = None
        self._next_id = 0

    # ---------------------------------------------------------- build ----
    def train(self, x) -> None:
        """Train the coarse quantizer (+ PQ codebooks) on offline vectors."""
        cents = kmeans(
            x, self.cfg.n_clusters, n_iter=self.cfg.kmeans_iters,
            seed=self.cfg.seed, device=self.device,
        )
        self.state = init_state(self.pool_cfg, torch.from_numpy(cents), self.device)
        if self.cfg.payload == "pq":
            # residuals of a sample against their centroid
            xs = torch.as_tensor(x[: min(len(x), 65536)], dtype=torch.float32)
            xs = xs.to(self.device)
            cents_d = self.state.centroids
            res = xs - cents_d[_assign_blockwise(xs, cents_d)]
            self.pq = pqmod.train_pq(res.cpu().numpy(), self.cfg.pq_m,
                                     seed=self.cfg.seed, device=self.device)
        self._build_fns()

    def _build_fns(self) -> None:
        """The mutation and maintenance steps for (``pool_cfg``, ``pq``);
        apart from ``train`` so that a restored state can be adopted
        without k-means (``install_state``)."""
        encode = pqmod.make_pq_encode_fn(self.pq) if self.pq else None
        self._insert_fn = make_insert_fn(self.pool_cfg, encode=encode)
        self._delete_fn = make_delete_fn(self.pool_cfg)
        self._update_fn = make_update_fn(self.pool_cfg, encode=encode)
        self._rearrange_fn = make_rearrange_fn(
            self.pool_cfg, self.cfg.rearrange_threshold,
            dead_frac=self.cfg.dead_frac_threshold,
        )

    def install_state(self, state: IVFState, *, pq=None,
                      next_id: int = 0) -> None:
        """Adopt a restored ``IVFState`` (recovery entry point): the
        centroids/codebooks travel inside the snapshot, so no training
        data is needed — only the config must match the snapshot schema,
        and the state must live on this index's device."""
        expect = self.pool_cfg.payload_shape()
        if tuple(state.pool_payload.shape) != expect:
            raise StateSchemaError(
                f"restored pool payload {tuple(state.pool_payload.shape)} "
                f"!= {expect} from config — wrong IVFIndexConfig for this "
                "snapshot"
            )
        if state.pool_payload.dtype != self.pool_cfg.payload_dtype():
            raise StateSchemaError(
                f"restored pool payload is {state.pool_payload.dtype}, the "
                f"config's is {self.pool_cfg.payload_dtype()}"
            )
        if state.device.type != self.device.type:
            raise ValueError(
                f"restored state is on {state.device}, the index on "
                f"{self.device}"
            )
        self.pq = pq
        self.state = state
        self._next_id = int(next_id)
        self._search_fns = {}
        self._build_fns()

    def add(self, x, ids=None) -> np.ndarray:
        """Insert a batch (offline load and online insertion share this).
        The pool is written in place."""
        if self.state is None:
            raise RuntimeError("train() first")
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        b = x.shape[0]
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + b, dtype=np.int32)
            # the serving runtime allocates ids itself, under _state_lock:
            # counter-ok: single writer by contract
            self._next_id += b
        ids = np.asarray(ids, np.int32)
        self.state = self._insert_fn(self.state, x, torch.from_numpy(ids))
        return ids

    # ------------------------------------------------------- mutations ----
    def delete(self, ids) -> int:
        """Tombstone a batch of ids; returns how many were found (misses,
        i.e. unknown, already deleted or unmappable ids, accrue in
        ``state.num_missed``).  The next compaction reclaims the space."""
        if self.state is None:
            raise RuntimeError("train() first")
        before = int(self.state.num_deleted)
        ids = torch.from_numpy(np.asarray(ids, np.int32))
        self.state = self._delete_fn(self.state, ids)
        return int(self.state.num_deleted) - before

    def update(self, x, ids) -> np.ndarray:
        """Replace the vectors behind ``ids`` in one step (tombstone +
        re-insert under the same id, no copy of any resident row).  Ids not
        resident become plain inserts (upsert) and count in
        ``num_missed``."""
        if self.state is None:
            raise RuntimeError("train() first")
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        ids = np.asarray(ids, np.int32)
        if len(ids) != x.shape[0]:
            raise ValueError(f"{len(ids)} ids for {x.shape[0]} vectors")
        self.state = self._update_fn(self.state, x, torch.from_numpy(ids))
        return ids

    def maybe_rearrange(self, max_passes: int = 4) -> int:
        """Compact offender chains until quiescent or ``max_passes`` ran;
        returns the number of passes run."""
        if self.state is None:
            raise RuntimeError("train() first")
        n = 0
        for _ in range(max_passes):
            self.state, triggered = self._rearrange_fn(self.state)
            if not triggered:
                break
            n += 1
        return n

    def stats(self) -> dict:
        """Live-occupancy / reclamation gauges (see block_pool.pool_stats)."""
        return pool_stats(self.state, self.pool_cfg)

    # --------------------------------------------------------- search ----
    def _chain_budget(self) -> int:
        """Scan bound: the longest live chain, bucketed to a power of two."""
        live = max(1, int(self.state.cluster_nblocks.max()))
        b = 1
        while b < live:
            b *= 2
        return min(b, self.cfg.max_chain)

    def _search_fn(self, nprobe: int, k: int, budget: int):
        key = (nprobe, k, self.cfg.search_path, self.cfg.use_kernel, budget,
               self.cfg.rerank)
        if key not in self._search_fns:
            score_fn = None
            if self.cfg.payload == "pq":
                # centroids come from the state argument, so cached search
                # steps never hold a stale pool copy
                score_fn = pqmod.pq_score_fn(
                    self.pq, use_kernel=self.cfg.use_kernel
                )
            self._search_fns[key] = make_search_fn(
                self.pool_cfg, nprobe=nprobe, k=k, path=self.cfg.search_path,
                score_fn=score_fn, chain_budget=budget, pq=self.pq,
                rerank=self.cfg.rerank,
            )
        return self._search_fns[key]

    def search(self, queries, nprobe=None, k=None):
        """Returns (dists [Q, k], ids [Q, k]) as numpy; ids are -1 past the
        corpus end."""
        if self.state is None:
            raise RuntimeError("train() first")
        nprobe = nprobe or self.cfg.nprobe
        k = k or self.cfg.k
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        d, i = self._search_fn(nprobe, k, self._chain_budget())(self.state, q)
        return d.cpu().numpy(), i.cpu().numpy()

    @property
    def ntotal(self) -> int:
        return int(self.state.num_vectors)


def _assign_blockwise(x: torch.Tensor, cents: torch.Tensor, chunk: int = 8192):
    """Memory-bounded argmin assignment for large training sets (ties go
    to the lower centroid id)."""
    outs = []
    cn = torch.sum(cents * cents, dim=1)
    for i in range(0, x.shape[0], chunk):
        xc = x[i : i + chunk]
        d = cn[None] - (2.0 * xc) @ cents.T
        outs.append(torch.argmin(d, dim=1))
    return torch.cat(outs)


def build_ivf(
    x,
    *,
    n_clusters: int,
    payload: str = "flat",
    pq_m: int = 0,
    block_size: int = 1024,
    capacity_vectors: Optional[int] = None,
    add_batch: int = 65536,
    device=None,
    **kw,
) -> IVFIndex:
    """Offline build: train + replay the corpus through batched inserts."""
    cfg = IVFIndexConfig(
        n_clusters=n_clusters,
        dim=x.shape[1],
        payload=payload,
        pq_m=pq_m,
        block_size=block_size,
        capacity_vectors=capacity_vectors or 2 * len(x),
        **kw,
    )
    index = IVFIndex(cfg, device=device)
    index.train(x)
    for i in range(0, len(x), add_batch):
        index.add(x[i : i + add_batch])
    return index
