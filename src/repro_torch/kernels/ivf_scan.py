"""Wrappers of the hand-written Hopper kernels of the IVF search path.

Same arguments, shapes, dtypes and return order as the JAX package's
``repro.kernels.ivf_scan`` wrappers of the same names:

* ``coarse_topk``    — streaming coarse probe (``csrc/coarse_topk.cu``);
* ``ivf_block_topk`` — fused block scan + streaming top-K' over float32 or
  bfloat16 blocks (``csrc/ivf_block_topk.cu``);
* ``rerank_topk``    — exact re-rank of the K' survivors
  (``csrc/rerank_topk.cu``).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything its kernel does not take, allocates the
outputs with ``torch.empty``, launches on the current stream, and raises
if the launch returns a CUDA error.  Nothing falls back to another
implementation.  ``kernels/ops.py`` picks between these wrappers and the
plain versions by the tensors' device.

Every launch adds one to ``LAUNCHES[<kernel>]``, so a run can show that
its path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# shared memory a block may use on Hopper (227 KB of the SM's 256 KB)
SMEM_LIMIT = 232_448

LAUNCHES: dict[str, int] = {
    "coarse_topk": 0,
    "ivf_block_topk[float32]": 0,
    "ivf_block_topk[bfloat16]": 0,
    "rerank_topk[float32]": 0,
    "rerank_topk[bfloat16]": 0,
    "rerank_topk[int8]": 0,
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "coarse_topk_f32": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "ivf_block_topk_f32": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P,
                           _I, _I, _I, _P, _P, _P, _P],
    "rerank_topk_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
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
    if (d + n) * 4 > SMEM_LIMIT:
        raise ValueError(
            f"coarse_topk keeps all {n} distances of a query in shared "
            f"memory; {n} centroids of dim {d} exceed {SMEM_LIMIT} bytes"
        )
    dev = queries.device
    out_i = torch.empty((q, nprobe), dtype=torch.int32, device=dev)
    out_d = torch.empty((q, nprobe), dtype=torch.float32, device=dev)
    if q == 0:
        return out_i, out_d
    _run("coarse_topk", "coarse_topk_f32", dev, queries.data_ptr(),
         centroids.data_ptr(), q, n, d, nprobe, out_i.data_ptr(),
         out_d.data_ptr())
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
