"""The paper's own index configurations (§3.3, §4).

* ``ivfflat_sift1m``  — SIFT1M-scale: dim 128, 4000 IVF lists (paper §4.3
  mentions "cluster number of ivf is 4000"), T_m = 1024 (deployment value).
* ``ivfpq_dssm40m``   — the industrial DSSM corpus: dim 64, PQ M=16.  The
  port has no PQ payload yet, so an index built from it raises.
"""

from __future__ import annotations

from repro_torch.core.ivf import IVFIndexConfig


def ivfflat_sift1m(scale: float = 1.0) -> IVFIndexConfig:
    n = int(1_000_000 * scale)
    return IVFIndexConfig(
        n_clusters=max(16, int(4000 * scale)),
        dim=128,
        block_size=1024 if scale >= 0.25 else 64,
        max_chain=64,
        capacity_vectors=2 * n,
        nprobe=32,
        k=10,
        rearrange_threshold=10_000,
    )


def ivfpq_dssm40m(scale: float = 1.0) -> IVFIndexConfig:
    n = int(40_000_000 * scale)
    return IVFIndexConfig(
        n_clusters=max(16, int(4000 * scale * 40)),
        dim=64,
        block_size=1024 if scale >= 0.01 else 64,
        max_chain=64,
        capacity_vectors=2 * n,
        payload="pq",
        pq_m=16,
        nprobe=32,
        k=10,
        rearrange_threshold=10_000,
    )
