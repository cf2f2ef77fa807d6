"""Wrappers of the hand-written Hopper kernels of the IVF search path.

Same arguments, shapes, dtypes and return order as the JAX package's
``repro.kernels.ivf_scan`` wrappers of the same names:

* ``coarse_topk``    — streaming coarse probe over any number of
  centroids (``csrc/coarse_topk.cu``);
* ``ivf_block_topk`` — fused block scan + streaming top-K' over float32 or
  bfloat16 blocks (``csrc/ivf_block_topk.cu``);
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

import ctypes

import torch

from repro_torch.core.block_pool import quantize_int8
from repro_torch.kernels import build

# shared memory a block may use on Hopper (227 KB of the SM's 256 KB)
SMEM_LIMIT = 232_448

LAUNCHES: dict[str, int] = {
    "coarse_topk": 0,
    "ivf_block_topk[float32]": 0,
    "ivf_block_topk[bfloat16]": 0,
    "ivf_block_topk_int8": 0,
    "ivf_pq_block_topk": 0,
    "rerank_topk[float32]": 0,
    "rerank_topk[bfloat16]": 0,
    "rerank_topk[int8]": 0,
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "coarse_topk_f32": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P],
    "ivf_block_topk_f32": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P,
                           _I, _I, _I, _P, _P, _P, _P],
    "rerank_topk_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "ivf_block_topk_int8": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P,
                            _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "ivf_pq_block_topk": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _I,
                          _I, _I, _P, _P, _P, _P],
    "pq_adc_f32": [_P, _P, _I, _I, _I, _P, _P],  # kernels/pq_adc.py
}
_SIGNATURES["ivf_block_topk_bf16"] = _SIGNATURES["ivf_block_topk_f32"]
_SIGNATURES["rerank_topk_bf16"] = _SIGNATURES["rerank_topk_f32"]
_SIGNATURES["rerank_topk_i8"] = _SIGNATURES["rerank_topk_f32"]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.int8: "int8"}


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _entry(source: str, symbol: str):
    lib = build.library(source)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, fn


def _run(source: str, symbol: str, device: torch.device, *args) -> None:
    lib, fn = _entry(source, symbol)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")


def _check(name: str, t: torch.Tensor, dtypes, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def split_centroids(q: int, n: int, d: int, nprobe: int,
                    n_sm: int) -> tuple[int, int, int, int]:
    """(TC, CB, chunk, S): how pass 1 of ``coarse_topk`` cuts N centroids
    into S chunks of whole tiles of TC, each query keeping an area of CB
    candidates beside its top-NP.  TC is the largest of 64, 32, 16, 8 whose
    tile and kQT = 8 query segments of next_pow2(NP + TC) keys fit in
    shared memory; S gives about four blocks per SM over the query tiles,
    while pass 2's S*NP keys of a query fit in shared memory; CB is up to
    four tiles (fewer sorts), as far as the chunk and shared memory allow."""
    keys_max = _next_pow2(SMEM_LIMIT // 8 + 1) // 2  # largest power of two
    if nprobe > keys_max:
        raise ValueError(
            f"coarse_topk merges S*NP keys of a query in shared memory; "
            f"nprobe {nprobe} exceeds {keys_max}"
        )

    def smem(tc: int, cb: int) -> int:
        return 8 * 8 * _next_pow2(nprobe + cb) + 4 * (8 * d + tc * (d + 1) + tc)

    tc = next((t for t in (64, 32, 16, 8) if smem(t, t) <= SMEM_LIMIT), None)
    if tc is None:
        raise ValueError(
            f"coarse_topk: nprobe {nprobe} at dim {d} exceeds {SMEM_LIMIT} "
            "bytes of shared memory"
        )
    q_tiles = -(-q // 8)
    s = max(1, min(-(-n // tc), -(-4 * n_sm // q_tiles), keys_max // nprobe))
    chunk = -(-(-(-n // s)) // tc) * tc
    cb = tc
    while cb < min(4 * tc, chunk) and smem(tc, 2 * cb) <= SMEM_LIMIT:
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
    _check("queries", queries, (torch.float32,), (q, d))
    _check("centroids", centroids, (torch.float32,), (n, d))
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
    _run("coarse_topk", "coarse_topk_f32", dev, queries.data_ptr(),
         centroids.data_ptr(), q, n, d, nprobe, tc, cb, chunk, s,
         partial.data_ptr(), out_i.data_ptr(), out_d.data_ptr())
    LAUNCHES["coarse_topk"] += 1
    return out_i, out_d


def split_candidates(c: int, q: int, kprime: int, n_sm: int) -> tuple[int, int]:
    """(S, chunk): how pass 1 of ``ivf_block_topk`` cuts C candidates into
    S chunks: about four blocks per SM over the Q x S grid, while pass 2's
    S*K' keys fit in shared memory as a power of two."""
    keys_max = _next_pow2(SMEM_LIMIT // 8 + 1) // 2  # largest power of two
    s_max = max(1, keys_max // _next_pow2(kprime))
    s = max(1, min(c, -(-4 * n_sm // max(q, 1)), s_max))
    chunk = -(-c // s)
    return -(-c // chunk), chunk


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
    _check("queries", queries, (torch.float32,), (q, d))
    _check("pool", pool, (torch.float32, torch.bfloat16), (p, t, d))
    _check("block_ids", block_ids, (torch.int32,), (c,))
    _check("block_owners", block_owners, (torch.int32,), (c,))
    _check("pool_ids", pool_ids, (torch.int32,), (p, t))
    _check("pool_live", pool_live, (torch.uint8,), (p, t))
    _check("probe_idx", probe_idx, (torch.int32,), (q, npr))
    if kprime <= 0:
        raise ValueError(f"kprime must be positive, got {kprime}")
    if _next_pow2(kprime + t) * 8 + (d + npr) * 4 > SMEM_LIMIT:
        raise ValueError(
            f"ivf_block_topk sorts K'+T = {kprime + t} keys in shared memory; "
            f"that exceeds {SMEM_LIMIT} bytes"
        )
    dev = queries.device
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
    _run("ivf_block_topk", f"ivf_block_topk_{_SUFFIX[pool.dtype]}", dev,
         queries.data_ptr(), pool.data_ptr(), t, d, block_ids.data_ptr(),
         block_owners.data_ptr(), c, chunk, s, pool_ids.data_ptr(),
         pool_live.data_ptr(), probe_idx.data_ptr(), q, npr, kprime,
         partial.data_ptr(), out_d.data_ptr(), out_i.data_ptr())
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
    _check("queries", queries, (torch.float32,), (q, d))
    _check("rows", rows, tuple(_SUFFIX), (q, kp, d))
    _check("scales", scales, (torch.float32,), (q, kp))
    _check("loc", loc, (torch.int32,), (q, kp))
    if _next_pow2(kp) * 8 + d * 4 > SMEM_LIMIT:
        raise ValueError(f"rerank_topk: K' = {kp} keys exceed shared memory")
    dev = queries.device
    out_d = torch.empty((q, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, kp), dtype=torch.int32, device=dev)
    if q == 0 or kp == 0:
        return out_d, out_i
    _run("rerank_topk", f"rerank_topk_{_SUFFIX[rows.dtype]}", dev,
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
    _check("q_codes", q_codes, (torch.int8,), (q, npr, d))
    _check("q_meta", q_meta, (torch.float32,), (q, npr, 2))
    _check("pool", pool, (torch.int8,), (p, t, d))
    _check("pool_scales", pool_scales, (torch.float32,), (p, t))
    _check("block_ids", block_ids, (torch.int32,), (c,))
    _check("block_owners", block_owners, (torch.int32,), (c,))
    _check("pool_ids", pool_ids, (torch.int32,), (p, t))
    _check("pool_live", pool_live, (torch.uint8,), (p, t))
    _check("probe_idx", probe_idx, (torch.int32,), (q, npr))
    if kprime <= 0:
        raise ValueError(f"kprime must be positive, got {kprime}")
    if d % 4 or q_codes.data_ptr() % 4 or pool.data_ptr() % 4:
        raise ValueError(
            f"ivf_block_topk_int8 reads codes as 4-byte words: dim {d} must "
            "be a multiple of 4 and the code tensors 4-byte aligned"
        )
    if _next_pow2(kprime + t) * 8 + d + npr * 4 > SMEM_LIMIT:
        raise ValueError(
            f"ivf_block_topk_int8 sorts K'+T = {kprime + t} keys in shared "
            f"memory; that exceeds {SMEM_LIMIT} bytes"
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
    _run("ivf_block_topk_int8", "ivf_block_topk_int8", dev,
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
    _check("lut", lut, (torch.float32,), (q, npr, m, 256))
    _check("pool_codes", pool_codes, (torch.uint8,), (p, t, m))
    _check("block_ids", block_ids, (torch.int32,), (c,))
    _check("block_owners", block_owners, (torch.int32,), (c,))
    _check("pool_ids", pool_ids, (torch.int32,), (p, t))
    _check("pool_live", pool_live, (torch.uint8,), (p, t))
    _check("probe_idx", probe_idx, (torch.int32,), (q, npr))
    if kprime <= 0:
        raise ValueError(f"kprime must be positive, got {kprime}")
    if _next_pow2(kprime + t) * 8 + (m * 256 + npr) * 4 > SMEM_LIMIT:
        raise ValueError(
            f"ivf_pq_block_topk sorts K'+T = {kprime + t} keys beside an "
            f"[{m}, 256] table in shared memory; that exceeds {SMEM_LIMIT} bytes"
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
    _run("ivf_pq_block_topk", "ivf_pq_block_topk", dev, lut.data_ptr(),
         pool_codes.data_ptr(), t, m, block_ids.data_ptr(),
         block_owners.data_ptr(), c, chunk, s, pool_ids.data_ptr(),
         pool_live.data_ptr(), probe_idx.data_ptr(), q, npr, kprime,
         partial.data_ptr(), out_d.data_ptr(), out_i.data_ptr())
    LAUNCHES["ivf_pq_block_topk"] += 1
    return out_d, out_i
