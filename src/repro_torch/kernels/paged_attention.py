"""Wrapper of the hand-written Hopper kernel of paged decode attention
(``csrc/paged_decode_attention.cu``).

Same arguments, shapes and result as the JAX package's
``repro.kernels.paged_attention.paged_decode_attention``: one query token
per sequence ``q [B, H, dh]`` against the K/V pools ``[P, T, KVH, dh]``
through the block tables ``[B, NB]`` (-1 past the end), positions at or
past ``lengths[b]`` masked; the result ``[B, H, dh]`` is in q's dtype.  It
serves ``serving/paged_lm.py::paged_decode_step`` once per layer.

The wrapper takes CUDA tensors only, checks them, allocates the output,
launches on the current stream and raises if the launch returns a CUDA
error; every launch adds one to ``LAUNCHES["paged_decode_attention"]``.
``kernels/ops.py`` picks between it and its plain version
(``ref.paged_decode_attention_ref``) by the tensors' device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import launch

MAX_BLOCK = 32  # positions per pool block: one per lane of a warp
MAX_GROUP = 8  # query heads per KV head held in registers
MAX_HEAD_DIM = 256

LAUNCHES: dict[str, int] = {"paged_decode_attention": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, dh] f32 | bf16
    k_pool: torch.Tensor,  # [P, T, KVH, dh], q's dtype
    v_pool: torch.Tensor,  # [P, T, KVH, dh], q's dtype
    block_tables: torch.Tensor,  # [B, NB] i32, -1 past the end
    lengths: torch.Tensor,  # [B] i32 positions resident
    *,
    scale: float | None = None,
) -> torch.Tensor:  # [B, H, dh] in q's dtype
    """Softmax attention of each sequence's query heads over its first
    ``lengths[b]`` cached positions (GQA: head h reads KV head
    ``h // (H // KVH)``), float32 inside."""
    b, h, dh = q.shape
    p, t, kvh, _ = k_pool.shape
    nb = block_tables.shape[1]
    launch.check("q", q, tuple(_SUFFIX), (b, h, dh))
    launch.check("k_pool", k_pool, (q.dtype,), (p, t, kvh, dh))
    launch.check("v_pool", v_pool, (q.dtype,), (p, t, kvh, dh))
    launch.check("block_tables", block_tables, (torch.int32,), (b, nb))
    launch.check("lengths", lengths, (torch.int32,), (b,))
    if h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(
            f"paged_decode_attention: {h} heads over {kvh} KV heads; groups "
            f"of up to {MAX_GROUP} query heads are supported"
        )
    if not 0 < t <= MAX_BLOCK or dh > MAX_HEAD_DIM or p == 0:
        raise ValueError(
            f"paged_decode_attention: block size {t} (1..{MAX_BLOCK}), head "
            f"dim {dh} (<= {MAX_HEAD_DIM}) and {p} pool blocks (> 0) unsupported"
        )
    if b > 2**31 - 1 or kvh > 65535:
        raise ValueError(f"paged_decode_attention: grid ({b}, {kvh}) too large")
    scale = float(dh) ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch.run(
        "paged_decode_attention", f"paged_decode_attention_{_SUFFIX[q.dtype]}",
        q.device, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), b, p, t, kvh, dh,
        h // kvh, nb, scale, out.data_ptr(),
    )
    LAUNCHES["paged_decode_attention"] += 1
    return out
