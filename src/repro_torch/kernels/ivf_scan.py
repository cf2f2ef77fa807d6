"""Wrappers of the hand-written Hopper kernels of the IVF search path.

Same arguments, shapes, dtypes and return order as the JAX package's
``repro.kernels.ivf_scan`` wrappers of the same names:

* ``coarse_topk``    — streaming coarse probe over any number of
  centroids (``csrc/coarse_topk.cu``);
* ``ivf_block_scan`` — scores only: the full [C, Q, T] squared-L2 tensor
  of the candidate blocks, for the ``union_pallas`` path
  (``csrc/ivf_block_scan.cu``);
* ``ivf_block_topk`` — fused block scan + streaming top-K' over the
  occupied rows of float32 or bfloat16 blocks (``csrc/ivf_block_topk.cu``);
* ``ivf_block_topk_int8`` — the same over int8 residual codes, scored by
  exact integer dots against per-probe query codes
  (``csrc/ivf_block_topk_int8.cu``);
* ``ivf_pq_block_topk`` — the same over uint8 PQ code blocks, scored by
  ADC against the table of each block's probe slot
  (``csrc/ivf_pq_block_topk.cu``);
* ``rerank_topk``    — exact re-rank of the K' survivors
  (``csrc/rerank_topk.cu``).

``kernels/pq_adc.py`` wraps the ADC sums of the ``block_table`` and
``chain_walk`` PQ paths (``csrc/pq_adc.cu``) the same way.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything its kernel does not take, allocates the
outputs with ``torch.empty``, launches on the current stream, and raises
if the launch returns a CUDA error.  Nothing falls back to another
implementation.  ``kernels/ops.py`` picks between these wrappers and the
plain versions by the tensors' device.

Every launch adds one to ``LAUNCHES[<kernel>]``, so a run can show that
its path went through the kernels.  ``quantize_queries`` is plain PyTorch:
it prepares the int8 kernel's query side on any device.
"""

from __future__ import annotations

import torch

from repro_torch.core.block_pool import quantize_int8
from repro_torch.kernels import launch

LAUNCHES: dict[str, int] = {
    "coarse_topk": 0,
    "ivf_block_scan[float32]": 0,
    "ivf_block_scan[bfloat16]": 0,
    "ivf_block_topk[float32]": 0,
    "ivf_block_topk[bfloat16]": 0,
    "ivf_block_topk_int8": 0,
    "ivf_pq_block_topk": 0,
    "rerank_topk[float32]": 0,
    "rerank_topk[bfloat16]": 0,
    "rerank_topk[int8]": 0,
}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.int8: "int8"}


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def split_centroids(q: int, n: int, d: int, nprobe: int,
                    n_sm: int) -> tuple[int, int, int, int]:
    """(TC, CB, chunk, S): how pass 1 of ``coarse_topk`` cuts N centroids
    into S chunks of whole tiles of TC, each query keeping an area of CB
    candidates beside its top-NP.  TC is the largest of 64, 32, 16, 8 whose
    tile and kQT = 8 query segments of next_pow2(NP + TC) keys fit in
    shared memory; S gives about four blocks per SM over the query tiles,
    while pass 2's S*NP keys of a query fit in shared memory; CB is up to
    four tiles (fewer sorts), as far as the chunk and shared memory allow."""
    keys_max = _next_pow2(launch.SMEM_LIMIT // 8 + 1) // 2  # largest power of two
    if nprobe > keys_max:
        raise ValueError(
            f"coarse_topk merges S*NP keys of a query in shared memory; "
            f"nprobe {nprobe} exceeds {keys_max}"
        )

    def smem(tc: int, cb: int) -> int:
        return 8 * 8 * _next_pow2(nprobe + cb) + 4 * (8 * d + tc * (d + 1) + tc)

    tc = next((t for t in (64, 32, 16, 8) if smem(t, t) <= launch.SMEM_LIMIT), None)
    if tc is None:
        raise ValueError(
            f"coarse_topk: nprobe {nprobe} at dim {d} exceeds {launch.SMEM_LIMIT} "
            "bytes of shared memory"
        )
    q_tiles = -(-q // 8)
    s = max(1, min(-(-n // tc), -(-4 * n_sm // q_tiles), keys_max // nprobe))
    chunk = -(-(-(-n // s)) // tc) * tc
    cb = tc
    while cb < min(4 * tc, chunk) and smem(tc, 2 * cb) <= launch.SMEM_LIMIT:
        cb *= 2
    return tc, cb, chunk, -(-n // chunk)


def coarse_topk(
    queries: torch.Tensor,  # [Q, D] f32
    centroids: torch.Tensor,  # [N, D] f32
    *,
    nprobe: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, NP] i32 ids, [Q, NP] dists asc)
    """Top-``nprobe`` nearest centroids, ascending by (distance, id)."""
    q, d = queries.shape
    n = centroids.shape[0]
    launch.check("queries", queries, (torch.float32,), (q, d))
    launch.check("centroids", centroids, (torch.float32,), (n, d))
    if not 0 < nprobe <= n:
        raise ValueError(f"nprobe must be in (0, {n}], got {nprobe}")
    dev = queries.device
    out_i = torch.empty((q, nprobe), dtype=torch.int32, device=dev)
    out_d = torch.empty((q, nprobe), dtype=torch.float32, device=dev)
    if q == 0:
        return out_i, out_d
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    tc, cb, chunk, s = split_centroids(q, n, d, nprobe, n_sm)
    partial = torch.empty((q, s, nprobe), dtype=torch.int64, device=dev)
    launch.run("coarse_topk", "coarse_topk_f32", dev, queries.data_ptr(),
               centroids.data_ptr(), q, n, d, nprobe, tc, cb, chunk, s,
               partial.data_ptr(), out_i.data_ptr(), out_d.data_ptr())
    LAUNCHES["coarse_topk"] += 1
    return out_i, out_d


def ivf_block_scan(
    queries: torch.Tensor,  # [Q, D] f32
    pool: torch.Tensor,  # [P, T, D] f32 | bf16
    block_ids: torch.Tensor,  # [C] i32 (-1 holes, scored against block 0)
) -> torch.Tensor:  # [C, Q, T] f32 squared L2
    """``||q||^2 + ||v||^2 - 2 q.v`` of every query against every row of
    every candidate block; bf16 blocks meet the query rounded to bf16."""
    q, d = queries.shape
    p, t, _ = pool.shape
    c = block_ids.shape[0]
    launch.check("queries", queries, (torch.float32,), (q, d))
    launch.check("pool", pool, (torch.float32, torch.bfloat16), (p, t, d))
    launch.check("block_ids", block_ids, (torch.int32,), (c,))
    n_ttiles = -(-t // 64)  # csrc/ivf_block_scan.cu kTileT, kTileQ
    if c * n_ttiles >= 2**31 or -(-q // 64) > 65535:
        raise ValueError(f"ivf_block_scan: C={c}, Q={q} exceed the grid")
    out = torch.empty((c, q, t), dtype=torch.float32, device=queries.device)
    if c == 0 or q == 0:
        return out
    launch.run("ivf_block_scan", f"ivf_block_scan_{_SUFFIX[pool.dtype]}",
               queries.device, queries.data_ptr(), pool.data_ptr(), q, t, d,
               block_ids.data_ptr(), c, out.data_ptr())
    LAUNCHES[f"ivf_block_scan[{_DTYPE_NAME[pool.dtype]}]"] += 1
    return out


def split_candidates(c: int, q: int, kprime: int, n_sm: int) -> tuple[int, int]:
    """(S, chunk): how pass 1 of the int8 and PQ scans cuts C candidates into
    S chunks: about four blocks per SM over the Q x S grid, while pass 2's
    S*K' keys fit in shared memory as a power of two."""
    keys_max = _next_pow2(launch.SMEM_LIMIT // 8 + 1) // 2  # largest power of two
    s_max = max(1, keys_max // _next_pow2(kprime))
    s = max(1, min(c, -(-4 * n_sm // max(q, 1)), s_max))
    chunk = -(-c // s)
    return -(-c // chunk), chunk


# csrc/ivf_block_topk.cu: bytes of a staged tile of rows, tiles in flight
# (a ring of 2-4), the slots a list of occupied rows holds
TOPK_TILE_BYTES, TOPK_STAGES, TOPK_LIST = 16384, 2, 4096


def split_members(q: int, c: int, t: int, d: int, esize: int, kprime: int,
                  n_sm: int) -> dict[str, int]:
    """How pass 1 of ``ivf_block_topk`` splits each query's member blocks:
    tiles of ``rows`` rows (about TOPK_TILE_BYTES), ``ns`` of them in
    flight, lists of ``list`` >= T occupied slots, ``seg`` keys for the
    top-K' and a candidate area of at least two tiles, the ``smem`` bytes
    a block uses, and ``s`` blocks a query: as many as the SMs hold at
    once (up to four each, as shared memory allows), so the grid runs in
    one wave, while pass 2's S sorted runs of K' keys fit in shared
    memory."""
    rows = 1 << max(0, min(8, (TOPK_TILE_BYTES // max(1, d * esize)).bit_length() - 1))
    lst = max(TOPK_LIST, t)
    seg = _next_pow2(2 * kprime + 2 * rows)
    smem = (4 * ((d + 3) & ~3) + 8 * seg + TOPK_STAGES * rows * d * esize
            + 4 * (lst + lst // t))
    per_sm = max(1, min(4, launch.SM_SHARED // (smem + 1024)))
    s_max = max(1, launch.SMEM_LIMIT // (8 * kprime) - 1)
    s = max(1, min(c, per_sm * n_sm // max(q, 1), s_max))
    return {"s": s, "rows": rows, "ns": TOPK_STAGES, "list": lst, "seg": seg,
            "smem": smem}


def ivf_block_topk(
    queries: torch.Tensor,  # [Q, D] f32
    pool: torch.Tensor,  # [P, T, D] f32 | bf16
    block_ids: torch.Tensor,  # [C] i32 (-1 holes, scored against block 0)
    block_owners: torch.Tensor,  # [C] i32 owning cluster (-1 = NULL slot)
    pool_ids: torch.Tensor,  # [P, T] i32 vector ids (-1 = empty slot)
    pool_live: torch.Tensor,  # [P, T] u8 live mask (0 = empty/tombstoned)
    probe_idx: torch.Tensor,  # [Q, NP] i32 distinct probed clusters per query
    *,
    kprime: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] dist asc, [Q, K'] locations)
    """Streaming top-``kprime`` over the member rows of the candidate
    blocks, ascending by (distance, packed location ``block*T + offset``);
    masked-out slots come back as (inf, -1)."""
    q, d = queries.shape
    p, t, _ = pool.shape
    c = block_ids.shape[0]
    npr = probe_idx.shape[1]
    launch.check("queries", queries, (torch.float32,), (q, d))
    launch.check("pool", pool, (torch.float32, torch.bfloat16), (p, t, d))
    launch.check("block_ids", block_ids, (torch.int32,), (c,))
    launch.check("block_owners", block_owners, (torch.int32,), (c,))
    launch.check("pool_ids", pool_ids, (torch.int32,), (p, t))
    launch.check("pool_live", pool_live, (torch.uint8,), (p, t))
    launch.check("probe_idx", probe_idx, (torch.int32,), (q, npr))
    if kprime <= 0:
        raise ValueError(f"kprime must be positive, got {kprime}")
    dev = queries.device
    plan = split_members(q, c, t, d, pool.element_size(), kprime,
                         launch.sm_count(dev))
    if plan["smem"] > launch.SMEM_LIMIT or npr * 4 > launch.SMEM_LIMIT:
        raise ValueError(
            f"ivf_block_topk: K' = {kprime}, T = {t}, dim {d} and nprobe {npr} "
            f"need more than {launch.SMEM_LIMIT} bytes of shared memory"
        )
    if c == 0 or q == 0:  # no candidate: nothing to launch
        return (
            torch.full((q, kprime), float("inf"), device=dev),
            torch.full((q, kprime), -1, dtype=torch.int32, device=dev),
        )
    if q > 2**31 - 1 or plan["s"] > 65535:
        raise ValueError(f"ivf_block_topk: grid ({q}, {plan['s']}) too large")
    vec = (d * pool.element_size()) % 16 == 0 and pool.data_ptr() % 16 == 0
    members = torch.empty((q * c + q,), dtype=torch.int32, device=dev)
    counts = members[q * c :]  # [Q] members of each query
    partial = torch.empty((q, plan["s"], kprime), dtype=torch.int64, device=dev)
    out_d = torch.empty((q, kprime), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, kprime), dtype=torch.int32, device=dev)
    launch.run("ivf_block_topk", f"ivf_block_topk_{_SUFFIX[pool.dtype]}", dev,
               queries.data_ptr(), pool.data_ptr(), t, d, block_ids.data_ptr(),
               block_owners.data_ptr(), c, plan["s"], pool_ids.data_ptr(),
               pool_live.data_ptr(), probe_idx.data_ptr(), q, npr, kprime,
               plan["rows"], plan["list"], plan["seg"], plan["ns"], int(vec),
               members.data_ptr(), counts.data_ptr(), partial.data_ptr(),
               out_d.data_ptr(), out_i.data_ptr())
    LAUNCHES[f"ivf_block_topk[{_DTYPE_NAME[pool.dtype]}]"] += 1
    return out_d, out_i


def rerank_topk(
    queries: torch.Tensor,  # [Q, D] f32
    rows: torch.Tensor,  # [Q, K', D] gathered survivor rows (f32|bf16|i8)
    scales: torch.Tensor,  # [Q, K'] f32 dequant scales (ones for f32/bf16)
    loc: torch.Tensor,  # [Q, K'] i32 packed candidate ids, -1 = invalid
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] exact dist asc, [Q, K'] locs)
    """Dequantize + exact fp32 distance + (distance, location) sort."""
    q, kp, d = rows.shape
    launch.check("queries", queries, (torch.float32,), (q, d))
    launch.check("rows", rows, tuple(_SUFFIX), (q, kp, d))
    launch.check("scales", scales, (torch.float32,), (q, kp))
    launch.check("loc", loc, (torch.int32,), (q, kp))
    if _next_pow2(kp) * 8 + d * 4 > launch.SMEM_LIMIT:
        raise ValueError(f"rerank_topk: K' = {kp} keys exceed shared memory")
    dev = queries.device
    out_d = torch.empty((q, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, kp), dtype=torch.int32, device=dev)
    if q == 0 or kp == 0:
        return out_d, out_i
    launch.run("rerank_topk", f"rerank_topk_{_SUFFIX[rows.dtype]}", dev,
               queries.data_ptr(), rows.data_ptr(), scales.data_ptr(),
               loc.data_ptr(), q, kp, d, out_d.data_ptr(), out_i.data_ptr())
    LAUNCHES[f"rerank_topk[{_DTYPE_NAME[rows.dtype]}]"] += 1
    return out_d, out_i


def quantize_queries(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of the int8 scan's query side:
    x [..., D] f32 -> (codes [..., D] i8, meta [..., 2] f32), meta holding
    the scale s and the reconstructed norm ``s^2 * sum(codes^2)``.  The
    same quantizer as the insert path, so query and pool codes share range
    and rounding; for the residual scheme x is the [Q, NP, D] batch of
    query residuals against every probed centroid."""
    codes, scale = quantize_int8(x)
    ci = codes.to(torch.int32)
    qn = (scale * scale) * torch.sum(ci * ci, dim=-1).to(torch.float32)
    return codes, torch.stack([scale, qn], dim=-1)


def ivf_block_topk_int8(
    q_codes: torch.Tensor,  # [Q, NP, D] i8 per-probe quantized query residuals
    q_meta: torch.Tensor,  # [Q, NP, 2] f32 (scale, reconstructed norm)
    pool: torch.Tensor,  # [P, T, D] i8 residual codes
    pool_scales: torch.Tensor,  # [P, T] f32 per-vector dequant scales
    block_ids: torch.Tensor,  # [C] i32 (-1 holes, scored against block 0)
    block_owners: torch.Tensor,  # [C] i32 owning cluster (-1 = NULL slot)
    pool_ids: torch.Tensor,  # [P, T] i32 vector ids (-1 = empty slot)
    pool_live: torch.Tensor,  # [P, T] u8 live mask (0 = empty/tombstoned)
    probe_idx: torch.Tensor,  # [Q, NP] i32 distinct probed clusters per query
    *,
    kprime: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] dist asc, [Q, K'] locations)
    """Streaming top-``kprime`` over an int8 residual-quantized pool: each
    member row is scored by an exact integer dot against the query
    residual of its block's probe slot, ascending by (distance, packed
    location ``block*T + offset``); masked-out slots come back as
    (inf, -1)."""
    q, npr, d = q_codes.shape
    p, t, _ = pool.shape
    c = block_ids.shape[0]
    launch.check("q_codes", q_codes, (torch.int8,), (q, npr, d))
    launch.check("q_meta", q_meta, (torch.float32,), (q, npr, 2))
    launch.check("pool", pool, (torch.int8,), (p, t, d))
    launch.check("pool_scales", pool_scales, (torch.float32,), (p, t))
    launch.check("block_ids", block_ids, (torch.int32,), (c,))
    launch.check("block_owners", block_owners, (torch.int32,), (c,))
    launch.check("pool_ids", pool_ids, (torch.int32,), (p, t))
    launch.check("pool_live", pool_live, (torch.uint8,), (p, t))
    launch.check("probe_idx", probe_idx, (torch.int32,), (q, npr))
    if kprime <= 0:
        raise ValueError(f"kprime must be positive, got {kprime}")
    if d % 4 or q_codes.data_ptr() % 4 or pool.data_ptr() % 4:
        raise ValueError(
            f"ivf_block_topk_int8 reads codes as 4-byte words: dim {d} must "
            "be a multiple of 4 and the code tensors 4-byte aligned"
        )
    if _next_pow2(kprime + t) * 8 + d + npr * 4 > launch.SMEM_LIMIT:
        raise ValueError(
            f"ivf_block_topk_int8 sorts K'+T = {kprime + t} keys in shared "
            f"memory; that exceeds {launch.SMEM_LIMIT} bytes"
        )
    dev = q_codes.device
    if c == 0 or q == 0:  # no candidate: nothing to launch
        return (
            torch.full((q, kprime), float("inf"), device=dev),
            torch.full((q, kprime), -1, dtype=torch.int32, device=dev),
        )
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    s, chunk = split_candidates(c, q, kprime, n_sm)
    partial = torch.empty((q, s, kprime), dtype=torch.int64, device=dev)
    out_d = torch.empty((q, kprime), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, kprime), dtype=torch.int32, device=dev)
    launch.run("ivf_block_topk_int8", "ivf_block_topk_int8", dev,
               q_codes.data_ptr(), q_meta.data_ptr(), pool.data_ptr(),
               pool_scales.data_ptr(), t, d, block_ids.data_ptr(),
               block_owners.data_ptr(), c, chunk, s, pool_ids.data_ptr(),
               pool_live.data_ptr(), probe_idx.data_ptr(), q, npr, kprime,
               partial.data_ptr(), out_d.data_ptr(), out_i.data_ptr())
    LAUNCHES["ivf_block_topk_int8"] += 1
    return out_d, out_i


def ivf_pq_block_topk(
    lut: torch.Tensor,  # [Q, NP, M, 256] f32 per-(query, probe) ADC tables
    pool_codes: torch.Tensor,  # [P, T, M] u8 PQ codes
    block_ids: torch.Tensor,  # [C] i32 (-1 holes, scored against block 0)
    block_owners: torch.Tensor,  # [C] i32 owning cluster (-1 = NULL slot)
    pool_ids: torch.Tensor,  # [P, T] i32 vector ids (-1 = empty slot)
    pool_live: torch.Tensor,  # [P, T] u8 live mask (0 = empty/tombstoned)
    probe_idx: torch.Tensor,  # [Q, NP] i32 distinct probed clusters per query
    *,
    kprime: int,
) -> tuple[torch.Tensor, torch.Tensor]:  # ([Q, K'] dist asc, [Q, K'] locations)
    """Streaming top-``kprime`` over a PQ-coded pool: each member row is
    scored by ADC with the table of its block's probe slot, ascending by
    (distance, packed location ``block*T + offset``); masked-out slots
    come back as (inf, -1)."""
    q, npr, m, _ = lut.shape
    p, t, _ = pool_codes.shape
    c = block_ids.shape[0]
    launch.check("lut", lut, (torch.float32,), (q, npr, m, 256))
    launch.check("pool_codes", pool_codes, (torch.uint8,), (p, t, m))
    launch.check("block_ids", block_ids, (torch.int32,), (c,))
    launch.check("block_owners", block_owners, (torch.int32,), (c,))
    launch.check("pool_ids", pool_ids, (torch.int32,), (p, t))
    launch.check("pool_live", pool_live, (torch.uint8,), (p, t))
    launch.check("probe_idx", probe_idx, (torch.int32,), (q, npr))
    if kprime <= 0:
        raise ValueError(f"kprime must be positive, got {kprime}")
    if _next_pow2(kprime + t) * 8 + (m * 256 + npr) * 4 > launch.SMEM_LIMIT:
        raise ValueError(
            f"ivf_pq_block_topk sorts K'+T = {kprime + t} keys beside an "
            f"[{m}, 256] table in shared memory; that exceeds {launch.SMEM_LIMIT} bytes"
        )
    dev = lut.device
    if c == 0 or q == 0:  # no candidate: nothing to launch
        return (
            torch.full((q, kprime), float("inf"), device=dev),
            torch.full((q, kprime), -1, dtype=torch.int32, device=dev),
        )
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    s, chunk = split_candidates(c, q, kprime, n_sm)
    partial = torch.empty((q, s, kprime), dtype=torch.int64, device=dev)
    out_d = torch.empty((q, kprime), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, kprime), dtype=torch.int32, device=dev)
    launch.run("ivf_pq_block_topk", "ivf_pq_block_topk", dev, lut.data_ptr(),
               pool_codes.data_ptr(), t, m, block_ids.data_ptr(),
               block_owners.data_ptr(), c, chunk, s, pool_ids.data_ptr(),
               pool_live.data_ptr(), probe_idx.data_ptr(), q, npr, kprime,
               partial.data_ptr(), out_d.data_ptr(), out_i.data_ptr())
    LAUNCHES["ivf_pq_block_topk"] += 1
    return out_d, out_i
