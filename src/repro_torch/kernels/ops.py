"""Public kernel entry points: dispatch on the tensors' device.

A CPU tensor goes to the kernel's plain PyTorch version (``kernels/ref.py``);
any other tensor goes to the hand-written CUDA kernel
(``kernels/ivf_scan.py``, ``kernels/pq_adc.py``,
``kernels/paged_attention.py``), which launches or raises.  There is no fallback
from the kernel to the plain version.
"""

from __future__ import annotations

from repro_torch.kernels import ivf_scan, paged_attention as _paged, ref
from repro_torch.kernels import pq_adc as _pq_adc


def _plain(t) -> bool:
    return t.device.type == "cpu"


def coarse_topk(queries, centroids, *, nprobe):
    """[Q,D] x [N,D] -> ([Q,NP] ids, [Q,NP] dists), ascending by
    (distance, centroid id)."""
    if _plain(queries):
        return ref.coarse_topk_ref(queries, centroids, nprobe=nprobe)
    return ivf_scan.coarse_topk(queries, centroids, nprobe=nprobe)


def ivf_block_scan(queries, pool, block_ids):
    """[Q, D] x [C] blocks of [P, T, D] -> [C, Q, T] squared L2 (scores
    only; the ``union_pallas`` path masks and selects)."""
    if _plain(queries):
        return ref.ivf_block_scan_ref(queries, pool, block_ids)
    return ivf_scan.ivf_block_scan(queries, pool, block_ids)


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


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           scale=None):
    """Decode attention over a block-pool KV cache: [B, H, dh] in q's
    dtype (see ``kernels/paged_attention.py``)."""
    if _plain(q):
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                              lengths, scale)
    return _paged.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                         lengths, scale=scale)


def _counters() -> tuple[dict[str, int], ...]:
    # read at call time: ivf_scan may still be importing when this module is
    return ivf_scan.LAUNCHES, _pq_adc.LAUNCHES, _paged.LAUNCHES


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel instance."""
    return {name: n for counts in _counters() for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _counters():
        for name in counts:
            counts[name] = 0
