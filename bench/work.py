"""The yardstick of the kernels' rooflines: the card's peaks and the work
each search dispatch's inputs need, counted the same whatever implements
it.

A dispatch of ``q`` query rows (the requests' rows; padding a batch up to
a bucket is not work the inputs need):

* ``coarse_topk``: every query against every centroid, ``2 q N D``
  float32 operations; the centroids and the queries read once and the
  ``nprobe`` (id, distance) pairs of each query written once.
* the scan (``ivf_block_topk`` over float32 rows, ``ivf_pq_block_topk``
  over PQ codes): every query against every row of its probed lists,
  ``2 D`` operations a pair for float32 rows and ``M`` table additions a
  pair for PQ codes; the rows of the lists the batch probes read once
  (payload, id and live byte), the queries or the per-(query, probe) ADC
  tables read once, and ``K'`` (distance, location) pairs of each query
  written once.

The lists a query probes are the reference's (``reference._probe_masks``'s
float32 twin below); the lists' lengths are the index's at the start of
the traced window.
"""

from __future__ import annotations

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
KSUB = 256


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def probes(queries: torch.Tensor, cents: torch.Tensor, nprobe: int,
           elems: int = 1 << 28) -> np.ndarray:
    """[Q, nprobe] nearest lists of each query (float32)."""
    cn = (cents * cents).sum(1)
    out = []
    step = max(1, elems // cents.shape[0])
    for off in range(0, queries.shape[0], step):
        d = torch.addmm(cn[None], queries[off : off + step], cents.T, alpha=-2.0)
        out.append(torch.topk(d, nprobe, dim=1, largest=False).indices.cpu())
    return torch.cat(out).numpy()


def coarse(q: int, n_lists: int, dim: int, nprobe: int) -> float:
    ops = 2.0 * q * n_lists * dim
    nbytes = 4.0 * (n_lists * dim + q * dim) + 8.0 * q * nprobe
    return bound_s(ops, nbytes)


def scan(probe: np.ndarray, list_len: np.ndarray, dim: int, *, pq_m: int = 0,
         kprime: int = 128) -> float:
    """Bound of one dispatch's scan; ``probe`` [q, nprobe] its queries'
    lists."""
    q, nprobe = probe.shape
    pairs = float(list_len[probe].sum())
    rows = float(list_len[np.unique(probe)].sum())
    out = 8.0 * q * kprime
    if pq_m:
        ops = pq_m * pairs
        nbytes = (pq_m + 5) * rows + 4.0 * q * nprobe * pq_m * KSUB + out
    else:
        ops = 2.0 * dim * pairs
        nbytes = (4 * dim + 5) * rows + 4.0 * q * dim + out
    return bound_s(ops, nbytes)


def share(bounds: list, launches: int, seconds: float):
    """Percent of the least time the traced launches could take (the
    mean bound of the window's dispatches, one launch group each) over
    the time they took; ``None`` where nothing was traced."""
    if not bounds or not launches or seconds <= 0:
        return None
    return 100.0 * float(np.mean(bounds)) * launches / seconds
