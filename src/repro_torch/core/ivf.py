"""User-facing IVFFlat index over the block pool.

``IVFIndex`` owns the insert and search steps and the ``IVFState``.  The
offline segment (paper §3.3) is built by k-means and by replaying batched
inserts through the same insertion path the online segment uses — there is
no separate bulk loader.

The index runs on ``cuda`` unless the caller passes ``device="cpu"``; on a
machine without a GPU, ``IVFIndex(cfg)`` raises rather than quietly running
on the CPU.  Deletes, updates and compaction arrive with the mutations
slice (ROADMAP queue 1, item 4) and PQ payloads with item 5; until then
they raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.block_pool import IVFState, PoolConfig, init_state, pool_stats
from repro_torch.core.insert import make_insert_fn
from repro_torch.core.kmeans import kmeans
from repro_torch.core.search import make_search_fn

#: Version stamp of the (field set, field semantics) of ``IVFState`` as
#: serialized by ``state_to_host`` — the reference's schema, so a state
#: written by either package loads in the other.
STATE_SCHEMA_VERSION = 1

_LATER_MUTATIONS = "ROADMAP queue 1, item 4 (mutations and compaction)"
_LATER_PQ = "ROADMAP queue 1, item 5 (PQ)"


class StateSchemaError(RuntimeError):
    """A serialized IVFState does not match this build's schema."""


class StateChecksumError(RuntimeError):
    """A serialized IVFState leaf failed its per-leaf CRC32."""


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def state_to_host(state: IVFState) -> "tuple[dict[str, np.ndarray], dict]":
    """The whole state as ``{field: np.ndarray}`` plus a schema and
    per-leaf CRC32 meta dict (JSON-serializable) — the same layout as the
    reference's ``state_to_host``.  bfloat16 leaves are stored as their
    uint16 bit pattern; the logical dtype is recorded in the meta."""
    fields = [f.name for f in dataclasses.fields(IVFState)]
    arrays: dict[str, np.ndarray] = {}
    leaves: dict[str, dict] = {}
    for name in fields:
        t = getattr(state, name).detach().cpu()
        if t.dtype == torch.bfloat16:
            arr, logical = t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        else:
            arr = t.numpy()
            logical = str(arr.dtype)
        arrays[name] = arr
        leaves[name] = {
            "crc32": _leaf_crc(arr),
            "dtype": logical,
            "shape": list(arr.shape),
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
    payload: str = "flat"  # "flat" | "pq" (PQ raises until it is ported)
    pq_m: int = 0
    dtype: str = "float32"  # flat payload dtype: float32 | bfloat16 | int8
    rerank: bool = False  # exact-fp32 re-rank epilogue (fused paths only)
    nprobe: int = 16
    k: int = 10
    rearrange_threshold: int = 10_000  # T'_m (paper Table 1 sweeps this)
    dead_frac_threshold: float = 0.3
    id_capacity: Optional[int] = None
    # the reference's path names (see core.search); only "union_fused" and
    # "union_fused_scan" are ported so far, the others raise
    search_path: str = "block_table"
    use_kernel: bool = False  # the reference's PQ scoring switch (unused)
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
    """IVFFlat with online insertion over the block pool."""

    def __init__(self, cfg: IVFIndexConfig, *, device=None):
        if cfg.payload == "pq":
            raise NotImplementedError(f"PQ payload: {_LATER_PQ}")
        self.cfg = cfg
        self.device = _resolve_device(device)
        self.pool_cfg = cfg.pool_config()
        self.state: Optional[IVFState] = None
        self._insert_fn = None
        self._search_fns: dict = {}
        self._next_id = 0

    # ---------------------------------------------------------- build ----
    def train(self, x) -> None:
        """Train the coarse quantizer on offline vectors."""
        cents = kmeans(
            x, self.cfg.n_clusters, n_iter=self.cfg.kmeans_iters,
            seed=self.cfg.seed, device=self.device,
        )
        self.state = init_state(self.pool_cfg, torch.from_numpy(cents), self.device)
        self._insert_fn = make_insert_fn(self.pool_cfg)

    def add(self, x, ids=None) -> np.ndarray:
        """Insert a batch (offline load and online insertion share this).
        The pool is written in place."""
        if self.state is None:
            raise RuntimeError("train() first")
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        b = x.shape[0]
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + b, dtype=np.int32)
            self._next_id += b
        ids = np.asarray(ids, np.int32)
        self.state = self._insert_fn(self.state, x, torch.from_numpy(ids))
        return ids

    # ------------------------------------------------------- mutations ----
    def delete(self, ids) -> int:
        raise NotImplementedError(f"delete: {_LATER_MUTATIONS}")

    def update(self, x, ids) -> np.ndarray:
        raise NotImplementedError(f"update: {_LATER_MUTATIONS}")

    def maybe_rearrange(self, max_passes: int = 4) -> int:
        raise NotImplementedError(f"compaction: {_LATER_MUTATIONS}")

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
        key = (nprobe, k, self.cfg.search_path, budget, self.cfg.rerank)
        if key not in self._search_fns:
            self._search_fns[key] = make_search_fn(
                self.pool_cfg, nprobe=nprobe, k=k, path=self.cfg.search_path,
                chain_budget=budget, rerank=self.cfg.rerank,
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
