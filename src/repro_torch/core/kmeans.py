"""K-means coarse quantizer training (``C = Kmeans(X, N)`` in Alg. 1/2).

Same algorithm as the reference: a random-subset init drawn with numpy
``default_rng(seed)`` (so both packages start from the same rows), Lloyd
iterations, and empty clusters re-seeded from the globally farthest points.
The assignment step is chunked so the ``[n, N]`` distance matrix never
exists whole (1M x 4000 would be 16 GB).  On a CUDA device ``index_add_``
sums with atomics, so centroids may differ from run to run in the last
bits.
"""

from __future__ import annotations

import numpy as np
import torch

# rows of x per assignment chunk: keeps the [chunk, N] distance block
# near 1 GB at N = 4000
_ASSIGN_ELEMS = 1 << 28


def _assign(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid of every row and its squared distance (ties go to
    the lower centroid id, as ``jnp.argmin``)."""
    cn = torch.sum(centroids * centroids, dim=1)
    chunk = max(1, _ASSIGN_ELEMS // max(1, centroids.shape[0]))
    assign, dist = [], []
    for i in range(0, x.shape[0], chunk):
        xc = x[i : i + chunk]
        d = (
            torch.sum(xc * xc, dim=1, keepdim=True)
            - 2.0 * (xc @ centroids.T)
            + cn[None]
        )
        m = torch.min(d, dim=1)
        assign.append(m.indices)
        dist.append(m.values)
    return torch.cat(assign), torch.cat(dist)


def _update(x, assign, centroids, n_clusters: int):
    sums = torch.zeros_like(centroids).index_add_(0, assign, x)
    cnts = torch.zeros(
        (n_clusters,), dtype=x.dtype, device=x.device
    ).index_add_(0, assign, torch.ones_like(x[:, 0]))
    new = sums / torch.clamp(cnts, min=1.0)[:, None]
    # keep the old centroid where a cluster went empty (re-seeded by caller)
    return torch.where(cnts[:, None] > 0, new, centroids), cnts


def kmeans(
    x,
    n_clusters: int,
    *,
    n_iter: int = 20,
    seed: int = 0,
    reseed_empty: bool = True,
    device="cuda",
) -> np.ndarray:
    """Train centroids on ``device``.  Returns float32 [n_clusters, D]
    (host array)."""
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    n = x.shape[0]
    if n < n_clusters:
        raise ValueError(f"need >= {n_clusters} points, got {n}")
    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(rng.choice(n, n_clusters, replace=False))
    centroids = x[pick.to(x.device)]
    for _ in range(n_iter):
        assign, dist = _assign(x, centroids)
        centroids, cnts = _update(x, assign, centroids, n_clusters)
        if reseed_empty:
            empty = torch.nonzero(cnts == 0).flatten()
            if empty.numel():
                far = torch.argsort(-dist, stable=True)[: empty.numel()]
                centroids[empty] = x[far]
    return centroids.cpu().numpy()
