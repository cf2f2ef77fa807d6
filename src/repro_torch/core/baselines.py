"""Comparison systems from the paper's experiment section (§4).

* ``FaissLikeIndex``: Alg. 1 semantics with Faiss's ``add`` behaviour: the
  affected lists round-trip through the *host* (device-to-host copy,
  concatenation on the host, host-to-device copy of the rebuilt storage).
* ``RaftLikeIndex``: RAFT ``extend``: the reallocation happens on the
  device: new tensors of ``len + new`` rows are made by ``torch.cat`` and
  the old ones dropped (a device-side copy-merge, no host round trip).
* ``RtCpuIndex``: the paper's Rt-cpu ablation: the memory-block insertion
  algorithm in numpy linked lists on the CPU.

All three expose ``IVFIndex``'s ``train``/``add``/``search``/``ntotal``
surface, so a benchmark drives them interchangeably.  The two realloc
baselines store each list as one contiguous tensor, the layout whose
growth cost the paper attacks, and run on the card unless the caller
passes ``device="cpu"``.  Their Python loops over lists and over queries
are the systems being compared: they stay as they are.

``train(x, centroids=...)`` takes trained centroids instead of running
k-means, so a comparison can give every system the same lists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ivf import _resolve_device
from repro_torch.core.kmeans import kmeans
from repro_torch.core.search import _smallest, exact_search, l2_sq


@dataclasses.dataclass
class _List:
    vecs: torch.Tensor  # [n, D] on the index's device
    ids: torch.Tensor  # [n]


class _ReallocIndexBase:
    """Contiguous per-list storage with realloc-on-insert (Alg. 1)."""

    host_roundtrip = False  # Faiss-style add copies through the host

    def __init__(self, n_clusters: int, dim: int, *, nprobe=16, k=10, seed=0,
                 kmeans_iters=10, device=None):
        self.n_clusters, self.dim = n_clusters, dim
        self.nprobe, self.k = nprobe, k
        self.seed, self.kmeans_iters = seed, kmeans_iters
        self.device = _resolve_device(device)
        self.centroids: Optional[torch.Tensor] = None
        self.lists: list[_List] = []
        self._next_id = 0

    def train(self, x: np.ndarray, centroids: Optional[np.ndarray] = None) -> None:
        cents = centroids if centroids is not None else kmeans(
            x, self.n_clusters, n_iter=self.kmeans_iters, seed=self.seed,
            device=self.device)
        self.centroids = torch.as_tensor(
            np.asarray(cents, np.float32)).to(self.device)
        self.lists = [
            _List(
                vecs=torch.zeros((0, self.dim), dtype=torch.float32,
                                 device=self.device),
                ids=torch.zeros((0,), dtype=torch.int32, device=self.device),
            )
            for _ in range(self.n_clusters)
        ]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _assign(self, x: torch.Tensor) -> np.ndarray:
        cn = torch.sum(self.centroids * self.centroids, dim=1)
        return torch.argmin(cn[None] - 2.0 * x @ self.centroids.T,
                            dim=1).cpu().numpy()

    def add(self, x, ids=None) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        b = x.shape[0]
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + b, dtype=np.int32)
            self._next_id += b
        assign = self._assign(x)
        # Alg. 1 lines 8-14: for every touched list, allocate len+new and merge
        for kcl in np.unique(assign):
            sel = assign == kcl
            new_v = x[torch.from_numpy(sel).to(self.device)]
            new_i = torch.as_tensor(ids[sel], dtype=torch.int32).to(self.device)
            lst = self.lists[int(kcl)]
            if self.host_roundtrip:
                # Faiss add: copy the list to the host, merge there, copy back
                hv = lst.vecs.cpu().numpy()
                hi = lst.ids.cpu().numpy()
                merged_v = np.concatenate([hv, new_v.cpu().numpy()], axis=0)
                merged_i = np.concatenate([hi, new_i.cpu().numpy()], axis=0)
                lst.vecs = torch.from_numpy(merged_v).to(self.device)  # re-upload
                lst.ids = torch.from_numpy(merged_i).to(self.device)
            else:
                # RAFT extend: device-side realloc + merge copy
                lst.vecs = torch.cat([lst.vecs, new_v], dim=0)
                lst.ids = torch.cat([lst.ids, new_i], dim=0)
            self._sync()
        return np.asarray(ids)

    def search(self, queries, nprobe=None, k=None):
        nprobe = nprobe or self.nprobe
        k = k or self.k
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        cd = l2_sq(q, self.centroids)
        probe = _smallest(cd, nprobe)[1].cpu().numpy()
        out_d = np.full((q.shape[0], k), np.inf, np.float32)
        out_i = np.full((q.shape[0], k), -1, np.int32)
        for qi in range(q.shape[0]):
            vs, is_ = [], []
            for kcl in probe[qi]:
                lst = self.lists[int(kcl)]
                if lst.vecs.shape[0]:
                    vs.append(lst.vecs)
                    is_.append(lst.ids)
            if not vs:
                continue
            corpus = torch.cat(vs, dim=0)
            cids = torch.cat(is_, dim=0)
            kk = min(k, corpus.shape[0])
            d, sel = exact_search(corpus, q[qi : qi + 1], kk)
            out_d[qi, :kk] = d[0].cpu().numpy()
            out_i[qi, :kk] = cids[sel[0].long()].cpu().numpy()
        return out_d, out_i

    @property
    def ntotal(self) -> int:
        return int(sum(lst.vecs.shape[0] for lst in self.lists))


class FaissLikeIndex(_ReallocIndexBase):
    host_roundtrip = True


class RaftLikeIndex(_ReallocIndexBase):
    host_roundtrip = False


class RtCpuIndex:
    """Paper's Rt-cpu: memory-block linked lists in numpy (CPU only)."""

    def __init__(self, n_clusters: int, dim: int, *, block_size=1024,
                 pool_blocks=None, nprobe=16, k=10, seed=0, kmeans_iters=10):
        self.n_clusters, self.dim, self.tm = n_clusters, dim, block_size
        self.nprobe, self.k = nprobe, k
        self.seed, self.kmeans_iters = seed, kmeans_iters
        self.pool_blocks = pool_blocks
        self._next_id = 0

    def train(self, x: np.ndarray, centroids: Optional[np.ndarray] = None) -> None:
        self.centroids = np.asarray(
            centroids if centroids is not None else kmeans(
                x, self.n_clusters, n_iter=self.kmeans_iters, seed=self.seed,
                device="cpu"),
            np.float32)
        p = self.pool_blocks or (len(x) * 2 // self.tm + self.n_clusters + 16)
        self.pool_vecs = np.zeros((p, self.tm, self.dim), np.float32)
        self.pool_ids = np.full((p, self.tm), -1, np.int64)
        self.next_block = np.full((p,), -1, np.int64)
        self.head = np.full((self.n_clusters,), -1, np.int64)
        self.tail = np.full((self.n_clusters,), -1, np.int64)
        self.length = np.zeros((self.n_clusters,), np.int64)
        self.cur_p = 0

    def add(self, x, ids=None) -> np.ndarray:
        x = np.asarray(x, np.float32)
        b = len(x)
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + b, dtype=np.int64)
            self._next_id += b
        cn = (self.centroids**2).sum(1)
        assign = np.argmin(cn[None] - 2.0 * x @ self.centroids.T, axis=1)
        for i in range(b):  # thread-per-vector loop, CPU serialised
            kcl = int(assign[i])
            did = self.length[kcl]
            moff = did % self.tm
            if moff == 0:  # allocate a block (bump)
                blk = self.cur_p
                self.cur_p += 1
                if self.tail[kcl] >= 0:
                    self.next_block[self.tail[kcl]] = blk
                else:
                    self.head[kcl] = blk
                self.tail[kcl] = blk
            blk = self.tail[kcl]
            self.pool_vecs[blk, moff] = x[i]
            self.pool_ids[blk, moff] = ids[i]
            self.length[kcl] += 1
        return np.asarray(ids)

    def search(self, queries, nprobe=None, k=None):
        nprobe = nprobe or self.nprobe
        k = k or self.k
        q = np.asarray(queries, np.float32)
        cn = (self.centroids**2).sum(1)
        cd = cn[None] - 2.0 * q @ self.centroids.T
        probe = np.argsort(cd, axis=1)[:, :nprobe]
        out_d = np.full((len(q), k), np.inf, np.float32)
        out_i = np.full((len(q), k), -1, np.int64)
        for qi in range(len(q)):
            vs, is_ = [], []
            for kcl in probe[qi]:
                cur = self.head[kcl]
                while cur >= 0:
                    mask = self.pool_ids[cur] >= 0
                    vs.append(self.pool_vecs[cur][mask])
                    is_.append(self.pool_ids[cur][mask])
                    cur = self.next_block[cur]
            if not vs:
                continue
            corpus = np.concatenate(vs)
            cids = np.concatenate(is_)
            d = ((corpus - q[qi]) ** 2).sum(1)
            kk = min(k, len(d))
            sel = np.argpartition(d, kk - 1)[:kk]
            sel = sel[np.argsort(d[sel])]
            out_d[qi, :kk] = d[sel]
            out_i[qi, :kk] = cids[sel]
        return out_d, out_i

    @property
    def ntotal(self) -> int:
        return int(self.length.sum())
