"""Wrapper of the hand-written Hopper kernel of paged decode attention
(``csrc/paged_decode_attention.cu``).

Same arguments, shapes and result as the JAX package's
``repro.kernels.paged_attention.paged_decode_attention``: one query token
per sequence ``q [B, H, dh]`` against the K/V pools ``[P, T, KVH, dh]``
through the block tables ``[B, NB]`` (-1 past the end), positions at or
past ``lengths[b]`` masked; the result ``[B, H, dh]`` is in q's dtype.  It
serves ``serving/paged_lm.py::paged_decode_step`` once per layer.

The wrapper takes CUDA tensors only, checks them, plans the split of each
sequence's blocks (``plan_splits``), allocates the output and the float32
partials with ``torch.empty``, launches pass 1 and its merge on the
current stream and raises if either returns a CUDA error; every call adds
one to ``LAUNCHES["paged_decode_attention"]``.
``kernels/ops.py`` picks between it and its plain version
(``ref.paged_decode_attention_ref``) by the tensors' device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import launch

MAX_GROUP = 8  # query heads per KV head a launch holds in registers
MAX_HEAD_DIM = 256
# csrc/paged_decode_attention.cu: threads a block and positions a tile
# (float32), warps (KV heads) a block at most and positions a warp step
# (bfloat16, tensor cores)
THREADS, TILE, MMA_WARPS, STEP = 128, 32, 4, 16
MAX_SPLIT_TILES = 32  # about 1024 positions per split
RING_BYTES = 48 * 1024  # float32 staging ring: 2-4 tiles
MMA_STAGES = 2  # bfloat16: steps in the block's ring

LAUNCHES: dict[str, int] = {"paged_decode_attention": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def tile_positions(t: int) -> int:
    """Positions of a float32 tile: whole pool blocks up to TILE, or TILE
    positions of one block over TILE (a block then spans several tiles)."""
    return (TILE // t) * t if t <= TILE else TILE


def plan_splits(b: int, kvh: int, g: int, nb: int, t: int, dh: int,
                esize: int, n_sm: int) -> dict[str, int]:
    """How pass 1 cuts each sequence's NB table entries: ``bps`` blocks per
    split, in units of ``tb`` blocks (the whole blocks of a 32-position
    tile, or one block over 32 positions), at most ``max_bps`` (about
    MAX_SPLIT_TILES x 32 positions, and one block at least); ``s`` splits:
    the shortest splits whose grid still runs in one wave of the blocks the
    SMs hold at once, or, where no split fits one wave, the longest, which
    the SMs then take in turn; ``ns`` stages in flight, the ``smem`` bytes a
    block uses, the grid's ``ctas``, the blocks the SMs hold at once
    (``resident``) and the ``scratch`` floats of the partials [b, kvh, s,
    gc, dh + 2].  A group of G query heads runs in launches of ``gc`` =
    min(G, MAX_GROUP) heads, one after the other, each over the same grid
    and scratch.  bfloat16 runs the tensor-core kernel: a block of ``hc``
    warps, one per KV head of a group, over a ring of 16-position steps of
    the group's rows; float32 the other: a block per (sequence, KV head)
    with a ring of tiles.  Pass 2 keeps gc x s split weights in shared
    memory."""
    gc = min(g, MAX_GROUP)
    tb = max(1, TILE // t)
    max_units = MAX_SPLIT_TILES if t <= TILE else max(1, MAX_SPLIT_TILES * TILE // t)
    n_units = -(-nb // tb)
    if esize == 2:
        hc = min(kvh, MMA_WARPS)
        ns = MMA_STAGES

        def ring(h):  # ns steps of K and V: 16 positions x (h heads, padded)
            return ns * 2 * STEP * (h * dh + 8) * 2

        fixed, units = ring(hc), b * -(-kvh // hc)
    else:
        nv = dh * esize // 16
        stage = 2 * tile_positions(t) * nv * 16
        ns = max(2, min(4, RING_BYTES // stage))
        mg = _pow2(gc)
        fixed = (max(ns * stage, (THREADS // nv) * gc * dh * 4)
                 + 4 * (mg * TILE + 3 * mg))
        units = b * kvh
    per_sm = max(1, min(4, launch.SM_SHARED
                        // (fixed + 4 * max_units * tb + 1024)))
    s_wave = per_sm * n_sm // units  # splits a sequence in one wave
    tiles = max_units
    if s_wave >= 1:
        tiles = max(1, min(max_units, -(-n_units // s_wave)))
    s = -(-n_units // tiles)
    bps = tiles * tb
    if esize == 2:  # as the kernel's launch: fewer heads if the ring overflows
        while hc > 1 and ring(hc) + 4 * bps > launch.SMEM_LIMIT:
            hc -= 1
        fixed, units = ring(hc), b * -(-kvh // hc)
    plan = {"bps": bps, "tb": tb, "max_bps": max_units * tb, "s": s, "ns": ns,
            "smem": fixed + 4 * bps, "ctas": units * s,
            "resident": per_sm * n_sm, "gc": gc,
            "scratch": b * kvh * s * gc * (dh + 2)}
    if esize == 2:
        plan["hc"] = hc
    return plan


def check_shapes(h: int, kvh: int, t: int, dh: int, esize: int) -> None:
    """Raise ``ValueError`` on a shape the kernels do not take.  The
    reference asserts only ``h % kvh == 0``; the kernels also need a block
    of at least one position and a head dim of at most MAX_HEAD_DIM, a
    multiple of 16 in bfloat16 (one mma step) or of 4 in float32 (one
    16-byte vector).  Blocks of any size and groups of any size are served:
    a block over 32 positions spans several tiles or steps, a group over
    MAX_GROUP heads runs in several launches."""
    if kvh <= 0 or h % kvh:
        raise ValueError(
            f"paged_decode_attention: {h} heads over {kvh} KV heads")
    if t < 1 or dh > MAX_HEAD_DIM or dh <= 0 or dh % (16 if esize == 2 else 4):
        raise ValueError(
            f"paged_decode_attention: block size {t} (>= 1), head dim {dh} "
            f"(<= {MAX_HEAD_DIM}, a multiple of 16 in bfloat16, of 4 in "
            "float32) unsupported"
        )


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
    esize = q.element_size()
    check_shapes(h, kvh, t, dh, esize)
    if p == 0 or nb == 0:
        raise ValueError(f"paged_decode_attention: {p} pool blocks and {nb} "
                         "table entries (both must be > 0)")
    if any(x.data_ptr() % 16 for x in (k_pool, v_pool)):
        raise ValueError("paged_decode_attention: the pools are read in "
                         "16-byte vectors and must be 16-byte aligned")
    if q.data_ptr() % 16:  # a view into a larger tensor: one small copy
        q = q.clone()
    plan = plan_splits(b, kvh, h // kvh, nb, t, dh, esize, launch.sm_count(q.device))
    if (b * kvh > 2**31 - 1 or kvh > 65535 or plan["s"] > 65535
            or 4 * plan["s"] * plan["gc"] > launch.SMEM_LIMIT):
        raise ValueError(
            f"paged_decode_attention: grid ({b}, {kvh}, {plan['s']}) too large")
    scale = float(dh) ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    if b == 0:
        return out
    partial = torch.empty(plan["scratch"], dtype=torch.float32, device=q.device)
    launch.run(
        "paged_decode_attention", f"paged_decode_attention_{_SUFFIX[q.dtype]}",
        q.device, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), b, p, t, kvh, dh,
        h // kvh, nb, plan["bps"], plan["s"], plan["ns"], scale,
        partial.data_ptr(), out.data_ptr(),
    )
    LAUNCHES["paged_decode_attention"] += 1
    return out
