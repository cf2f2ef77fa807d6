"""How the port's split kernels cut their work, and the plain version of
the paged attention's split-K merge.

The planners (``paged_attention.plan_splits``, ``ivf_scan.split_members``)
run on the host, so their plans are checked here on the CPU at the shapes
the port serves: llama3-8b's [serve] (16 x 576 positions) and
[decode_32k] (32,768 positions), and the SIFT1M and DSSM search batches.
Every position and every member block falls in exactly one split, and
each block's shared memory stays within ``launch.SMEM_LIMIT``.

``ref.paged_decode_attention_split_ref`` computes the kernel's split-K
scheme (per-split max, sum and numerator, merged by rescaling) in plain
PyTorch; it is held to the plain version ``paged_decode_attention_ref``
and to the JAX package's ``paged_decode_attention`` (its Pallas kernel in
interpret mode, as the reference's own tests run it on the CPU) on the
same numpy inputs, within 2e-5 in float32 (sums in another order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_decode_attention as jpaged
from repro_torch.kernels import ivf_scan, launch, paged_attention, ref

N_SM = 132  # the H100's SMs
TOL = 2e-5


def _split_cover(nb: int, t: int, bps: int, s: int) -> np.ndarray:
    """How many splits hold each position of a full table, as pass 1 of
    csrc/paged_decode_attention.cu assigns them (split i: positions
    [i*bps*t, (i+1)*bps*t))."""
    hits = np.zeros(nb * t, np.int64)
    for i in range(s):
        hits[i * bps * t : (i + 1) * bps * t] += 1
    return hits


@pytest.mark.parametrize("b,kvh,g,nb,t,dh,esize", [
    (16, 8, 4, 36, 16, 128, 2),  # llama3-8b [serve]: 576 positions
    (32, 8, 4, 2048, 16, 128, 2),  # [decode_32k], the batch chip_smoke runs
    (128, 8, 4, 2048, 16, 128, 2),  # [decode_32k] at LM_SHAPES' batch
    (2, 8, 4, 2048, 16, 128, 2),  # 2 x 32,768 positions: many splits
    (1, 4, 1, 2, 32, 128, 4),  # G = 1, blocks of 32
    (5, 2, 3, 3, 16, 48, 4),  # G = 3, dh off the warp width
    (3, 1, 8, 5, 8, 64, 2),  # G = 8
    (4, 8, 8, 9, 32, 256, 4),  # the largest rows: float32, dh 256
    (3, 2, 2, 5, 4, 16, 4),  # the smoke config's blocks of 4
])
def test_plan_splits_covers_every_position_once(b, kvh, g, nb, t, dh, esize):
    plan = paged_attention.plan_splits(b, kvh, g, nb, t, dh, esize, N_SM)
    bps, s = plan["bps"], plan["s"]
    tb = max(1, paged_attention.TILE // t)
    assert bps % tb == 0  # whole tiles of whole blocks
    assert s * bps >= nb > (s - 1) * bps  # no split is empty at full length
    assert (_split_cover(nb, t, bps, s) == 1).all()
    assert 1 <= s <= 65535 and 2 <= plan["ns"] <= 4
    assert bps <= paged_attention.MAX_SPLIT_TILES * tb
    assert plan["smem"] <= launch.SMEM_LIMIT
    assert 4 * s * g <= launch.SMEM_LIMIT  # pass 2's split weights
    assert plan["scratch"] == b * kvh * s * g * (dh + 2)
    # one wave of resident blocks, with the shortest whole-tile splits that
    # keep it one wave; or, where no split fits one wave, the longest
    tiles = bps // tb
    if plan["ctas"] <= plan["resident"]:
        units = plan["ctas"] // s
        shorter = -(-(-(-nb // tb)) // (tiles - 1)) if tiles > 1 else None
        assert shorter is None or units * shorter > plan["resident"]
    else:
        assert tiles == paged_attention.MAX_SPLIT_TILES
    # the float32 partials are a small fraction of the K/V read at full
    # length once a sequence spans several splits
    if s > 1 and nb * t >= 512:
        kv_bytes = 2 * b * nb * t * kvh * dh * esize
        assert 4 * plan["scratch"] <= kv_bytes // 4


@pytest.mark.parametrize("q,c,t,d,esize,kprime", [
    (64, 1570, 1024, 128, 4, 128),  # SIFT1M, float32
    (64, 1570, 1024, 128, 2, 128),  # SIFT1M, bfloat16
    (64, 2505, 1024, 64, 4, 128),  # DSSM's candidate list and block shape
    (4096, 2505, 1024, 64, 4, 128),  # a large batch: one split a query
    (13, 12, 16, 16, 4, 16),  # the card tests' hand-made pool
    (1, 300, 64, 32, 2, 128),
    (64, 1570, 1024, 960, 4, 128),  # wide rows: tiles of a few rows
])
def test_split_members_covers_every_member_once(q, c, t, d, esize, kprime):
    plan = ivf_scan.split_members(q, c, t, d, esize, kprime, N_SM)
    s = plan["s"]
    assert 1 <= s <= c and plan["smem"] <= launch.SMEM_LIMIT
    assert (s + 1) * kprime * 8 <= launch.SMEM_LIMIT  # pass 2's sorted runs
    seg, rows = plan["seg"], plan["rows"]
    assert seg & (seg - 1) == 0 and seg - kprime >= 2 * rows  # area >= 2 tiles
    assert rows & (rows - 1) == 0 and plan["list"] >= t and 2 <= plan["ns"] <= 4
    assert rows * d * esize <= ivf_scan.TOPK_TILE_BYTES or rows == 1
    # pass 1 gives split i the members [n*i // S, n*(i+1) // S) of a query
    # with n members, in groups of list // t blocks
    per_group = plan["list"] // t
    for n in sorted({0, 1, s - 1, s, s + 1, 32, c}):
        hits = np.zeros(n, np.int64)
        for i in range(s):
            lo, hi = n * i // s, n * (i + 1) // s
            for g0 in range(lo, hi, per_group):
                hits[g0 : min(hi, g0 + per_group)] += 1
        assert (hits == 1).all()


def _paged_inputs(b, h, kvh, dh, t, nb, lengths, seed):
    rng = np.random.default_rng(seed)
    p = nb * b + 2
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    kp = rng.normal(size=(p, t, kvh, dh)).astype(np.float32)
    vp = rng.normal(size=(p, t, kvh, dh)).astype(np.float32)
    perm = rng.permutation(p)[: b * nb].reshape(b, nb).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    tables = np.where(np.arange(nb)[None, :] * t < np.maximum(lengths, 1)[:, None],
                      perm, -1).astype(np.int32)
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("b,h,kvh,dh,t,nb,bps", [
    (6, 8, 2, 64, 16, 6, 2),  # GQA, three splits
    (6, 4, 4, 32, 8, 6, 4),  # MHA (G = 1), the last split partly past the table
    (6, 8, 1, 16, 4, 6, 1),  # MQA (G = 8), one block a split
    (6, 6, 2, 16, 16, 6, 6),  # G = 3, one split
])
def test_paged_split_ref_matches_plain_and_jax(b, h, kvh, dh, t, nb, bps):
    """Lengths 0, 1, on a split edge, one past it, two splits, full."""
    edge = bps * t
    lengths = [min(x, nb * t) for x in (0, 1, edge, edge + 1, 2 * edge, nb * t)]
    q, kp, vp, tables, lengths = _paged_inputs(b, h, kvh, dh, t, nb, lengths,
                                               seed=h * 10 + bps)
    targs = [torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)]
    got = ref.paged_decode_attention_split_ref(*targs, bps=bps)
    assert got.shape == (b, h, dh) and got.dtype == torch.float32
    assert (got[0] == 0).all()  # length 0 gives zeros
    plain = ref.paged_decode_attention_ref(*targs)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    for want in (jref.paged_decode_attention_ref(*jargs),
                 jpaged(*jargs, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_kernel_signatures_match_sources():
    """Every ``extern "C"`` entry point in ``kernels/csrc`` has a ctypes
    signature of the same length and kinds in ``launch.SIGNATURES``: a
    pointer (the stream included) for every pointer, a C int for every
    int, a C float for every float.  ctypes passes an argument past its
    list as a C int, so a missing stream pointer reaches the kernel with
    its upper half undefined."""
    import ctypes
    import re

    from repro_torch.kernels import build

    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    found = set()
    for name in build.sources():
        text = (build.CSRC / f"{name}.cu").read_text()
        for sym, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text, re.S):
            want = []
            for param in params.split(","):
                decl = " ".join(param.split())
                kind = "void*" if "*" in decl else decl.split()[-2]
                want.append(kinds[kind])
            assert launch.SIGNATURES[sym] == want, sym
            found.add(sym)
    assert found == set(launch.SIGNATURES)
