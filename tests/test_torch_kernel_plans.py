"""How the port's split kernels cut their work, and the plain version of
the paged attention's split-K merge.

The planners (``paged_attention.plan_splits``, ``ivf_scan.split_members``,
``ivf_scan.split_members_int8``, ``ivf_scan.split_members_pq``,
``ivf_scan.split_centroids``, ``ivf_scan.plan_block_scan``,
``pq_adc.plan_adc``) run on the
host, so their plans are checked here on the CPU at the shapes the port
serves: llama3-8b's [serve] (16 x 576 positions) and [decode_32k] (32,768
positions), pool blocks over 32 positions and GQA groups over 8 heads, and
the SIFT1M and DSSM search batches.  Every position, every member block and
every centroid falls in exactly one split, and each block's shared memory
stays within ``launch.SMEM_LIMIT``.  ``paged_attention.check_shapes`` is
held to every LM config of the reference.

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

from repro.configs.base import get_arch, list_archs
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_decode_attention as jpaged
from repro_torch.kernels import ivf_scan, launch, paged_attention, pq_adc, ref

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


@pytest.mark.parametrize("q,c,t,d,esize", [
    (64, 1569, 1024, 128, 4),  # SIFT1M's union_pallas batch, float32
    (64, 1569, 1024, 128, 2),  # the same, bfloat16
    (200, 60, 100, 40, 4),  # several query tiles, a partial row tile
    (1, 300, 1, 13, 2),  # rows of one value a tile, dims off a stage
    (65, 1, 1024, 136, 2),  # one candidate
    (64, 7, 300, 700, 4),  # float32 query tile held in slabs
    (64, 7, 300, 1300, 2),  # bf16 query tile held in slabs
    (9000, 3, 64, 4096, 4),  # more query tiles than SMs, very wide rows
    (64, 2_000_000, 64, 8, 2),  # C near the grid's former limit
])
def test_plan_block_scan_covers_every_row_once(q, c, t, d, esize):
    """Every (query tile, candidate, row) falls in exactly one worker's
    item, every dim in one stage of one slab of the query tile, and a
    block's shared memory stays within the limit: the shapes the first
    design took are all taken."""
    plan = ivf_scan.plan_block_scan(q, c, t, d, esize, N_SM)
    chunk, slab, ns = plan["chunk"], plan["slab"], plan["ns"]
    assert plan["smem"] <= launch.SMEM_LIMIT and 2 <= ns <= 4
    assert slab % chunk == 0 and chunk * esize == 128  # 128 bytes a row a stage
    dpad = -(-d // chunk) * chunk
    assert slab == dpad or ns == 2  # resident wherever two stages leave room
    # the slabs' stages cover dims [0, dpad) once
    dims = np.zeros(dpad, np.int64)
    for ch in range(dpad // chunk):
        sl = ch // (slab // chunk)
        assert sl * slab + (ch - sl * (slab // chunk)) * chunk == ch * chunk
        dims[ch * chunk : (ch + 1) * chunk] += 1
    assert (dims == 1).all()
    n_tiles, items, w = plan["n_tiles"], plan["items"], plan["workers"]
    assert items == c * n_tiles and 1 <= w <= max(1, items)
    assert plan["qtiles"] == -(-q // ivf_scan.SCAN_QT) <= 65535
    assert w * plan["qtiles"] <= max(N_SM, plan["qtiles"])  # one block an SM
    # worker i takes items [items*i // W, items*(i+1) // W); item it is
    # candidate it // n_tiles, rows (it % n_tiles) * 256 + [0, 256) below T
    hits = np.zeros(items, np.int64)
    for i in range(w):
        hits[items * i // w : items * (i + 1) // w] += 1
    assert (hits == 1).all()
    if items <= 10_000:
        rows = np.zeros((c, t), np.int64)
        for it in range(items):
            t0 = (it % n_tiles) * ivf_scan.SCAN_ROWS
            rows[it // n_tiles, t0 : t0 + ivf_scan.SCAN_ROWS] += 1
        assert (rows == 1).all()


@pytest.mark.parametrize("r,n,m", [
    (2048, 2048, 16),  # block_table at the DSSM deployment
    (2048, 1024, 16),  # chain_walk
    (6, 40, 8), (3, 5000, 225), (3, 2049, 64), (1, 1, 1), (1000, 1024, 16),
    (64, 5000, 16), (200_000, 31, 3),
    (1, 65535 * 2048, 16),  # the first design's longest row of codes
    (5, 700, 227),  # the largest table shared memory holds
])
def test_plan_adc_covers_every_row_once(r, n, m):
    """Every (table, code row) falls in exactly one item of one block; the
    grid fits the SMs at once with runs of equal length but the last; the
    table fits in shared memory."""
    plan = pq_adc.plan_adc(r, n, m, N_SM)
    nc, rpc, ipb, grid, items = plan["nc"], plan["rpc"], plan["ipb"], plan["grid"], plan["items"]
    assert plan["smem"] == m * 1024 <= launch.SMEM_LIMIT
    assert items == r * nc < 2**31 and nc == -(-n // rpc)
    assert nc == 1 or rpc >= pq_adc.ADC_MIN_ROWS
    per_sm = min(pq_adc.ADC_BLOCKS_PER_SM, launch.SM_SHARED // (m * 1024 + 1024))
    assert (grid - 1) * ipb < items <= grid * ipb and grid <= per_sm * N_SM
    # block b takes items [b*ipb, min(items, (b+1)*ipb)); item it covers
    # table it // nc, rows (it % nc) * rpc + [0, rpc) below N
    if r * n <= 5_000_000:
        hits = np.zeros((r, n), np.int64)
        for it in range(items):
            hits[it // nc, (it % nc) * rpc : (it % nc + 1) * rpc] += 1
        assert (hits == 1).all()


def _kernel_positions(nb: int, t: int, bps: int, s: int, step: int) -> np.ndarray:
    """How many times pass 1 reads each (table entry, slot) of a full table
    when a split's positions go in tiles (float32) or steps (bfloat16) of
    ``step``: position p of split i is slot p % t of entry i*bps + p // t,
    as csrc/paged_decode_attention.cu computes it."""
    hits = np.zeros((nb, t), np.int64)
    for i in range(s):
        n_pos = min(bps * t, nb * t - i * bps * t)
        for p0 in range(0, n_pos, step):
            for p in range(p0, min(n_pos, p0 + step)):
                hits[i * bps + p // t, p % t] += 1
    return hits


@pytest.mark.parametrize("b,kvh,g,nb,t,dh,esize", [
    (4, 2, 4, 9, 48, 64, 4),  # blocks of 48: tiles straddle blocks
    (4, 2, 4, 9, 48, 64, 2),
    (16, 8, 4, 36, 64, 128, 4),  # [serve]'s positions in blocks of 64
    (16, 8, 4, 36, 64, 128, 2),
    (2, 8, 4, 256, 128, 128, 2),  # 32,768 positions in blocks of 128
    (3, 2, 4, 7, 128, 32, 4),
    (16, 2, 16, 36, 16, 128, 2),  # G = 16 (H 32 over 2 KV heads)
    (5, 2, 16, 9, 64, 64, 4),  # G = 16 and blocks of 64
    (3, 1, 12, 5, 8, 16, 4),  # G = 12: launches of 8 and 4 heads
])
def test_plan_splits_large_blocks_and_groups(b, kvh, g, nb, t, dh, esize):
    plan = paged_attention.plan_splits(b, kvh, g, nb, t, dh, esize, N_SM)
    bps, s, tb = plan["bps"], plan["s"], plan["tb"]
    assert tb == (max(1, paged_attention.TILE // t))
    assert bps % tb == 0 and bps <= plan["max_bps"]
    if t > paged_attention.TILE:  # at least a block, about 1024 positions
        assert plan["max_bps"] == max(1, paged_attention.MAX_SPLIT_TILES
                                      * paged_attention.TILE // t)
    assert s * bps >= nb > (s - 1) * bps
    assert (_split_cover(nb, t, bps, s) == 1).all()
    step = (paged_attention.STEP if esize == 2
            else paged_attention.tile_positions(t))
    assert step <= paged_attention.TILE
    assert (_kernel_positions(nb, t, bps, s, step) == 1).all()
    gc = min(g, paged_attention.MAX_GROUP)
    assert plan["gc"] == gc and plan["scratch"] == b * kvh * s * gc * (dh + 2)
    assert 1 <= s <= 65535 and plan["smem"] <= launch.SMEM_LIMIT
    assert 4 * s * gc <= launch.SMEM_LIMIT
    heads = [min(paged_attention.MAX_GROUP, g - g0)
             for g0 in range(0, g, paged_attention.MAX_GROUP)]
    assert sum(heads) == g and max(heads) <= paged_attention.MAX_GROUP


def _lm_configs():
    out = []
    for arch in list_archs():
        spec = get_arch(arch)
        if spec.family == "lm":
            for name, cfg in (("full", spec.config), ("smoke", spec.smoke_config)):
                out.append(pytest.param(cfg, id=f"{arch}-{name}"))
    return out


@pytest.mark.parametrize("cfg", _lm_configs())
@pytest.mark.parametrize("esize", [2, 4])
def test_lm_configs_pass_paged_shape_checks(cfg, esize):
    """Every LM config of the reference, in bfloat16 and float32, at the
    reference's paged block size (4, its tests), the served one (16) and
    blocks over 32 positions, passes the kernel wrapper's shape checks,
    and its plan fits shared memory: the card serves what the reference
    serves."""
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    for t in (4, 16, 48, 64, 128):
        paged_attention.check_shapes(h, kvh, t, dh, esize)
        plan = paged_attention.plan_splits(16, kvh, h // kvh, 4096 // t, t, dh,
                                           esize, N_SM)
        assert plan["smem"] <= launch.SMEM_LIMIT
        assert 4 * plan["s"] * plan["gc"] <= launch.SMEM_LIMIT


@pytest.mark.parametrize("h,kvh,t,dh,esize", [
    (8, 3, 16, 64, 2),  # heads not a multiple of the KV heads
    (8, 2, 0, 64, 4),  # an empty block
    (8, 2, 16, 272, 2),  # dh over 256
    (8, 2, 16, 260, 4),
    (8, 2, 16, 40, 2),  # bf16: dh not a multiple of 16
    (8, 2, 16, 18, 4),  # float32: dh not a multiple of 4
])
def test_paged_shape_checks_pin_the_remaining_limits(h, kvh, t, dh, esize):
    """The kernels' remaining domain (ROADMAP "Faults found"): dh <= 256, a
    multiple of 16 in bfloat16 or of 4 in float32; blocks and groups of any
    size pass."""
    with pytest.raises(ValueError):
        paged_attention.check_shapes(h, kvh, t, dh, esize)
    paged_attention.check_shapes(64, 4, 1000, 128, esize)  # G 16, T 1000


def _members(owners: np.ndarray, probe: np.ndarray):
    """Each query's member candidates in candidate order, with the probe
    slot of each, as ``list_members`` (csrc/topk_common.cuh) lists them."""
    out = []
    for pr in probe:
        slot = {int(o): p for p, o in enumerate(pr)}
        out.append([(c, slot[int(o)]) for c, o in enumerate(owners)
                    if o >= 0 and int(o) in slot])
    return out


@pytest.mark.parametrize("q,c,t,d,kprime", [
    (64, 1570, 1024, 128, 128),  # SIFT1M's int8 batch
    (64, 60, 1024, 128, 128),
    (13, 12, 16, 16, 16),  # the card tests' hand-made pool
    (5, 8, 64, 36, 16),  # rows of 36 bytes: staged by 4-byte loads
    (9, 40, 1024, 128, 128),
    (2, 300, 64, 32, 37),
])
def test_split_members_int8_covers_every_member_once(q, c, t, d, kprime):
    """Pass 1 of ``ivf_block_topk_int8`` gives split i of a query with n
    members the members [n*i // S, n*(i+1) // S), in groups of ``grp``
    blocks, and stages for each the query row of its probe slot: every
    (query, member) pair is scored once, against the probe slot whose
    cluster owns it (the plain version's ``_pslot_from_owners``)."""
    plan = ivf_scan.split_members_int8(q, c, t, d, kprime, N_SM)
    s, grp, rows, seg = plan["s"], plan["grp"], plan["rows"], plan["seg"]
    assert 1 <= s <= c and plan["smem"] <= launch.SMEM_LIMIT
    assert (s + 1) * kprime * 8 <= launch.SMEM_LIMIT  # pass 2's sorted runs
    assert seg & (seg - 1) == 0 and seg - kprime >= 2 * rows
    assert rows & (rows - 1) == 0 and 2 <= plan["ns"] <= 4
    assert grp >= 1 and grp * t <= plan["list"] < 2**16 * t  # 2-byte members
    dq = (d + 15) & ~15
    assert grp * dq <= ivf_scan.INT8_QROW_BYTES or grp == 1
    rng = np.random.default_rng(c + q)
    ncl, npr = max(4, c // 6), 4
    owners = rng.integers(0, ncl, c).astype(np.int32)
    owners[rng.random(c) < 0.2] = -1  # holes: NULL owners
    probe = np.stack([rng.permutation(ncl)[:npr] for _ in range(q)]).astype(np.int32)
    want = ref._pslot_from_owners(torch.from_numpy(probe), torch.from_numpy(owners))
    for qi, mem in enumerate(_members(owners, probe)):
        n, seen = len(mem), {}
        for i in range(s):
            lo, hi = n * i // s, n * (i + 1) // s
            for g0 in range(lo, hi, grp):
                group = mem[g0 : min(hi, g0 + grp)]
                assert len(group) <= grp
                for cand, slot in group:
                    seen[cand] = seen.get(cand, 0) + 1
                    assert probe[qi, slot] == owners[cand]
                    assert int(want[qi, cand]) == slot
        members = set(int(x) for x in torch.nonzero(want[qi] >= 0).flatten())
        assert set(seen) == members and all(v == 1 for v in seen.values())


@pytest.mark.parametrize("q,c,t,m,kprime,npr,nt", [
    (64, 2503, 1024, 16, 128, 32, 2),  # the DSSM deployment
    (8, 5, 16, 8, 128, 4, 2),  # the card tests' hand-made pool, M = 8
    (9, 60, 1024, 16, 128, 8, 2),
    (5, 40, 64, 12, 37, 6, 2),  # M off 16: rows staged by 4-byte loads
    (4, 30, 1024, 200, 128, 4, 1),  # one table: two would not fit
    (3, 12, 16, 225, 100, 3, 1),  # one table, one-row tiles
    (2, 6, 4096, 150, 4096, 2, 0),  # no table fits: read from device memory
])
def test_split_members_pq_covers_every_member_once(q, c, t, m, kprime, npr, nt):
    """Pass 1 of ``ivf_pq_block_topk`` gives split i of a query with n
    members the members [n*i // S, n*(i+1) // S), in groups of at most
    ``grp`` consecutive blocks of one probe slot, each scored with the
    table of that slot: every (query, member) pair is scored once, against
    the probe slot whose cluster owns it (the plain version's
    ``_pslot_from_owners``).  Shared memory stays within the limit, with two
    tables where they fit, one near the limit the first design's wrapper
    took (``_next_pow2(K' + T) * 8 + (M * 256 + NP) * 4`` bytes), and none
    beyond it."""
    assert (ivf_scan._next_pow2(kprime + t) * 8 + (m * 256 + npr) * 4
            <= launch.SMEM_LIMIT)  # a shape the first design took
    plan = ivf_scan.split_members_pq(q, c, t, m, kprime, N_SM)
    s, grp, rows, seg = plan["s"], plan["grp"], plan["rows"], plan["seg"]
    assert plan["nt"] == nt
    assert plan["smem"] == ivf_scan._pq_smem(m, seg, nt, plan["ns"], rows,
                                              plan["list"], grp)
    assert 1 <= s <= c and plan["smem"] <= launch.SMEM_LIMIT
    assert s == 1 or (s + 1) * kprime * 8 <= launch.SMEM_LIMIT  # pass 2's runs
    assert seg & (seg - 1) == 0 and seg - kprime >= rows
    assert rows & (rows - 1) == 0 and 1 <= plan["ns"] <= 4
    assert 1 <= grp <= ivf_scan.PQ_THREADS and grp * t <= plan["list"]
    if nt == 2:  # the default tiles, with an area of two
        assert (rows, seg) == ivf_scan._member_tiles(t, m, kprime, ivf_scan.PQ_TILE_BYTES,
                                                     ivf_scan.PQ_LIST)[::2]
    if (q, c, t, m) == (64, 2503, 1024, 16):  # four blocks an SM, one wave
        assert plan["smem"] + 1024 <= launch.SM_SHARED // 4 and s * q <= 4 * N_SM
    rng = np.random.default_rng(c + q + m)
    ncl = max(npr + 1, c // 2)
    owners = rng.integers(0, ncl, c).astype(np.int32)
    owners[rng.random(c) < 0.2] = -1  # holes: NULL owners
    probe = np.stack([rng.permutation(ncl)[:npr] for _ in range(q)]).astype(np.int32)
    want = ref._pslot_from_owners(torch.from_numpy(probe), torch.from_numpy(owners))
    for qi, mem in enumerate(_members(owners, probe)):
        n, seen = len(mem), {}
        for i in range(s):
            lo, hi = n * i // s, n * (i + 1) // s
            g0 = lo
            while g0 < hi:  # a group: a run of one slot, at most grp blocks
                g1 = g0 + 1
                while g1 < hi and g1 - g0 < grp and mem[g1][1] == mem[g0][1]:
                    g1 += 1
                for cand, slot in mem[g0:g1]:
                    seen[cand] = seen.get(cand, 0) + 1
                    assert slot == mem[g0][1] and probe[qi, slot] == owners[cand]
                    assert int(want[qi, cand]) == slot
                g0 = g1
        members = set(int(x) for x in torch.nonzero(want[qi] >= 0).flatten())
        assert set(seen) == members and all(v == 1 for v in seen.values())


@pytest.mark.parametrize("q,n,d,nprobe", [
    (64, 1, 16, 1),
    (13, 31, 16, 31),  # nprobe = N
    (64, 31, 128, 8),
    (64, 4000, 128, 32),  # SIFT1M
    (7, 4000, 128, 32),
    (200, 4000, 128, 32),  # four query tiles
    (64, 160_000, 64, 32),  # DSSM: 160,000 lists
    (9, 160_000, 64, 300),
])
def test_split_centroids_covers_every_centroid_once(q, n, d, nprobe):
    """Pass 1 of ``coarse_topk`` gives chunk i the centroids [i*chunk,
    min(N, (i+1)*chunk)) in tiles of COARSE_TILE: every centroid falls in
    one chunk, S stays within its cap, and the segments, the staged slices
    and pass 2's (S + 1) * NP keys of a query fit in shared memory."""
    qt, seg, chunk, s = ivf_scan.split_centroids(q, n, d, nprobe, N_SM)
    n_tiles = -(-n // ivf_scan.COARSE_TILE)
    assert qt in (8, 16, 32, 64)
    if qt < min(q, 64) and qt > 8:  # halved: for shared memory or for the SMs
        assert (ivf_scan._coarse_smem(2 * qt, seg) > launch.SMEM_LIMIT
                or -(-q // (2 * qt)) * min(n_tiles, ivf_scan.COARSE_MAX_SPLITS)
                < N_SM // 4)
    assert seg & (seg - 1) == 0 and seg >= nprobe + ivf_scan.COARSE_AREA
    assert ivf_scan._coarse_smem(qt, seg) <= launch.SMEM_LIMIT
    assert chunk % ivf_scan.COARSE_TILE == 0
    assert 1 <= s <= ivf_scan.COARSE_MAX_SPLITS and s * chunk >= n > (s - 1) * chunk
    assert (s + 1) * nprobe * 8 <= launch.SMEM_LIMIT
    hits = np.zeros(n, np.int64)
    for i in range(s):
        hits[i * chunk : min(n, (i + 1) * chunk)] += 1
    assert (hits == 1).all()
    if n >= 4000:  # pass 1 splits the centroids over many blocks
        assert s * -(-q // qt) >= min(-(-n // ivf_scan.COARSE_TILE), 32)


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
    (6, 4, 2, 16, 64, 3, 1),  # blocks of 64 positions, one a split
    (6, 32, 2, 16, 4, 4, 2),  # G = 16: two launches of 8 heads on the card
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
