"""Public kernel entry points: dispatch on the tensors' device.

A CPU tensor goes to the kernel's plain PyTorch version (``kernels/ref.py``);
any other tensor goes to the hand-written CUDA kernel
(``kernels/ivf_scan.py``, ``kernels/pq_adc.py``), which launches or
raises.  There is no fallback
from the kernel to the plain version.
"""

from __future__ import annotations

from repro_torch.kernels import ivf_scan, pq_adc as _pq_adc, ref


def _plain(t) -> bool:
    return t.device.type == "cpu"


def coarse_topk(queries, centroids, *, nprobe):
    """[Q,D] x [N,D] -> ([Q,NP] ids, [Q,NP] dists), ascending by
    (distance, centroid id)."""
    if _plain(queries):
        return ref.coarse_topk_ref(queries, centroids, nprobe=nprobe)
    return ivf_scan.coarse_topk(queries, centroids, nprobe=nprobe)


def ivf_block_topk(queries, pool, block_ids, block_owners, pool_ids,
                   pool_live, probe_idx, *, kprime):
    """Fused streaming selection: ([Q,K'] dists asc, [Q,K'] locations)
    over the member rows of the candidate blocks."""
    if _plain(queries):
        return ref.ivf_block_topk_ref(
            queries, pool, block_ids, block_owners, pool_ids, pool_live,
            probe_idx, kprime=kprime,
        )
    return ivf_scan.ivf_block_topk(
        queries, pool, block_ids, block_owners, pool_ids, pool_live,
        probe_idx, kprime=kprime,
    )


def ivf_block_topk_int8(q_codes, q_meta, pool, pool_scales, block_ids,
                        block_owners, pool_ids, pool_live, probe_idx, *,
                        kprime):
    """The int8 residual variant: ([Q,K'] dists asc, [Q,K'] locations)."""
    fn = (ref.ivf_block_topk_int8_ref if _plain(q_codes)
          else ivf_scan.ivf_block_topk_int8)
    return fn(q_codes, q_meta, pool, pool_scales, block_ids, block_owners,
              pool_ids, pool_live, probe_idx, kprime=kprime)


def ivf_pq_block_topk(lut, pool_codes, block_ids, block_owners, pool_ids,
                      pool_live, probe_idx, *, kprime):
    """The PQ-ADC variant: ([Q,K'] dists asc, [Q,K'] locations) over
    [Q,NP,M,256] tables and [P,T,M] u8 code blocks."""
    fn = (ref.ivf_pq_block_topk_ref if _plain(lut)
          else ivf_scan.ivf_pq_block_topk)
    return fn(lut, pool_codes, block_ids, block_owners, pool_ids, pool_live,
              probe_idx, kprime=kprime)


def pq_adc(lut, codes):
    """[R,M,256] x [R,N,M] u8 -> [R,N] ADC distances."""
    if _plain(lut):
        return ref.pq_adc_ref(lut, codes)
    return _pq_adc.pq_adc(lut, codes)


def rerank_topk(queries, rows, scales, loc):
    """Exact re-rank epilogue: dequant + exact fp32 distance +
    (distance, location) sort."""
    if _plain(queries):
        return ref.rerank_topk_ref(queries, rows, scales, loc)
    return ivf_scan.rerank_topk(queries, rows, scales, loc)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel instance."""
    return {**ivf_scan.LAUNCHES, **_pq_adc.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (ivf_scan.LAUNCHES, _pq_adc.LAUNCHES):
        for name in counts:
            counts[name] = 0
