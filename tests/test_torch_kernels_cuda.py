"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Marked ``cuda``: they skip without a card.  On the card, run them with
``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.  This
file imports no JAX, so it runs where only PyTorch is installed; the CPU
tests in ``test_torch_kernels.py`` take their inputs from here.

Tolerance: distances within rtol 1e-5 and atol 1e-4 (float32 sums taken in
another order); ids equal except inside groups of distances that lie
within that tolerance of each other (``ref.topk_mismatches``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ivf_scan, ops, pq_adc, ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(x):
    return torch.from_numpy(np.asarray(x))




def _coarse_inputs(q, n, d, seed, dup=False):
    rng = np.random.default_rng(seed)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    cents = rng.normal(size=(n, d)).astype(np.float32)
    if dup:  # exact ties: every centroid appears twice, lower id must win
        cents[n // 2 : 2 * (n // 2)] = cents[: n // 2]
    return queries, cents


def _pool_inputs(dtype, seed=0, q=13, p=12, t=16, d=16, n_clusters=8, np_=4):
    """A hand-made pool with every case the scan masks: empty slots, rows
    tombstoned by zeroing pool_live, hole candidates (-1) with NULL
    owners, free blocks owning NULL, and fewer live rows than K'."""
    rng = np.random.default_rng(seed)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    pool = rng.normal(size=(p, t, d)).astype(np.float32)
    if dtype == "bfloat16":  # bf16-representable values on both sides
        pool = _t(pool).to(torch.bfloat16).float().numpy()
    pool_ids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    fill = rng.integers(0, t + 1, p)
    for b in range(p):
        pool_ids[b, fill[b]:] = -1  # empty tail slots
    live = (pool_ids != -1).astype(np.uint8)
    live[rng.random((p, t)) < 0.15] = 0  # tombstones keep their stale id
    owner_of_block = rng.integers(0, n_clusters, p).astype(np.int32)
    owner_of_block[[3, 7]] = -1  # free blocks
    block_ids = np.array([0, 1, 2, -1, 4, 5, 6, 7, -1, 9, 10, 11], np.int32)
    owners = np.where(block_ids == -1, -1, owner_of_block[np.maximum(block_ids, 0)])
    probe = np.stack(
        [rng.permutation(n_clusters)[:np_] for _ in range(q)]
    ).astype(np.int32)
    return queries, pool, block_ids, owners.astype(np.int32), pool_ids, live, probe


def _torch_pool(pool, dtype):
    return _t(pool).to(getattr(torch, dtype))


def _int8_inputs(seed=0, ties=False, q=13, p=12, t=16, d=16, n_clusters=8, np_=4):
    """The int8 scan's inputs over ``_pool_inputs``' pool layout (empty
    slots, tombstones, holes, NULL owners, k > live): int8 codes with one
    scale per row, and one quantized query residual per (query, probe).
    With ``ties``, every block holds the same rows (equal codes and
    scale), so each query meets exact ties that must come back in location
    order."""
    _, _, bids, owners, pids, live, probe = _pool_inputs(
        "float32", seed, q=q, p=p, t=t, d=d, n_clusters=n_clusters, np_=np_)
    rng = np.random.default_rng(seed + 100)
    codes = rng.integers(-127, 128, (p, t, d)).astype(np.int8)
    scales = rng.uniform(0.01, 0.05, (p, t)).astype(np.float32)
    if ties:
        codes[:], scales[:] = codes[1].copy(), scales[1].copy()
    q_codes = rng.integers(-127, 128, (q, np_, d)).astype(np.int8)
    sq = rng.uniform(0.01, 0.05, (q, np_)).astype(np.float32)
    qn = (sq * sq) * np.sum(q_codes.astype(np.int32) ** 2, axis=-1).astype(np.float32)
    q_meta = np.stack([sq, qn], axis=-1).astype(np.float32)
    return q_codes, q_meta, codes, scales, bids, owners, pids, live, probe


def _pq_inputs(seed=0, ties=False, q=8, npb=4, m=8, p=6, t=16, c=5, ncl=None):
    """The PQ scan's inputs, shaped as the reference's ``_pq_topk_inputs``
    (``tests/test_pq_fused.py``): hole candidates (-1) with NULL owners,
    empty id slots, tombstones, owners outside a query's probe list, one
    ADC table per (query, probe).  With ``ties``, every block holds the
    same codes, so rows of one probe slot tie exactly and must come back
    in location order."""
    rng = np.random.default_rng(seed)
    ncl = ncl or 2 * npb  # about half the (query, candidate) pairs are members
    lut = (rng.normal(size=(q, npb, m, 256)) ** 2).astype(np.float32)
    codes = rng.integers(0, 256, size=(p, t, m)).astype(np.uint8)
    if ties:
        codes[:] = codes[0].copy()
        codes[:, 1::2] = codes[:, 0:1]  # ties inside a block as well
    ids = rng.integers(0, p, size=(c,)).astype(np.int32)
    ids[rng.random(c) < 0.25] = -1
    pool_ids = rng.permutation(p * t).astype(np.int32).reshape(p, t)
    pool_ids[rng.random((p, t)) < 0.3] = -1
    live = (pool_ids != -1).astype(np.uint8)
    live[rng.random((p, t)) < 0.1] = 0  # tombstones keep their stale id
    owners = rng.integers(0, ncl, size=(c,)).astype(np.int32)
    owners[ids == -1] = -1
    probe = np.stack([rng.permutation(ncl)[:npb] for _ in range(q)]).astype(np.int32)
    return lut, codes, ids, owners, pool_ids, live, probe


def _adc_inputs(seed=0, r=6, n=40, m=8, ties=False):
    rng = np.random.default_rng(seed)
    lut = (rng.normal(size=(r, m, 256)) ** 2).astype(np.float32)
    codes = rng.integers(0, 256, size=(r, n, m)).astype(np.uint8)
    if ties:
        codes[:, 1::2] = codes[:, 0:1]
    return lut, codes


# ------------------------------------------------- kernels on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _agree(dk, ik, dp, ip, atol=1e-4):
    faults = ref.topk_mismatches(dk.cpu(), ik.cpu(), dp.cpu(), ip.cpu(),
                                 rtol=1e-5, atol=atol)
    assert not faults, faults[:5]


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d,nprobe,dup", [
    (13, 37, 16, 4, False), (64, 4000, 128, 32, False), (7, 40, 16, 8, True),
    # the DSSM deployment's lists: far more than one block's shared memory
    (64, 160_000, 64, 32, False), (9, 20_000, 64, 40, True),
    # chunks of 10 tiles: the candidate areas fill and are merged mid-chunk
    (64, 40_000, 32, 16, True),
])
def test_coarse_topk_kernel_matches_plain(cuda, q, n, d, nprobe, dup):
    queries, cents = _coarse_inputs(q, n, d, seed=n, dup=dup)
    args = (_t(queries).to(cuda), _t(cents).to(cuda))
    ki, kd = ivf_scan.coarse_topk(*args, nprobe=nprobe)
    pi, pd = ref.coarse_topk_ref(*args, nprobe=nprobe)
    torch.cuda.synchronize()
    _agree(kd, ki, pd, pi)
    if dup:
        assert torch.equal(ki, pi)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    if n >= 4000:  # pass 1 split the centroids into several chunks
        assert ivf_scan.split_centroids(q, n, d, nprobe, n_sm)[3] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kprime", [128, 16])
def test_ivf_block_topk_kernel_matches_plain(cuda, dtype, kprime):
    queries, pool, bids, owners, pids, live, probe = _pool_inputs(dtype, seed=1)
    args = [_t(queries), _torch_pool(pool, dtype), _t(bids), _t(owners),
            _t(pids), _t(live), _t(probe)]
    args = [a.to(cuda) for a in args]
    kd, ki = ivf_scan.ivf_block_topk(*args, kprime=kprime)
    pd, pi = ref.ivf_block_topk_ref(*args, kprime=kprime)
    torch.cuda.synchronize()
    _agree(kd, ki, pd, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivf_block_topk_kernel_many_candidates(cuda, dtype):
    """Enough member blocks that pass 1 splits each query's members."""
    rng = np.random.default_rng(5)
    q, p, t, d, n_clusters, np_ = 9, 300, 64, 32, 50, 6
    queries = rng.normal(size=(q, d)).astype(np.float32)
    pool = _t(rng.normal(size=(p, t, d)).astype(np.float32)).to(getattr(torch, dtype))
    pids = _t(np.arange(p * t, dtype=np.int32).reshape(p, t))
    live = torch.ones((p, t), dtype=torch.uint8)
    live[:, 50:] = 0
    owners = _t(rng.integers(0, n_clusters, p).astype(np.int32))
    bids = torch.arange(p, dtype=torch.int32)
    probe = _t(np.stack([rng.permutation(n_clusters)[:np_] for _ in range(q)])
               .astype(np.int32))
    args = [a.to(cuda) for a in (_t(queries), pool, bids, owners, pids, live, probe)]
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ivf_scan.split_members(q, p, t, d, pool.element_size(), 128, n_sm)["s"] > 1
    kd, ki = ivf_scan.ivf_block_topk(*args, kprime=128)
    pd, pi = ref.ivf_block_topk_ref(*args, kprime=128)
    torch.cuda.synchronize()
    _agree(kd, ki, pd, pi)


def _int_rows(rng, n, d):
    """Small integer vectors: every dot and norm is exact in float32 and
    bf16 in any order, so equal rows tie exactly in kernel and plain."""
    return rng.integers(-3, 4, size=(n, d)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivf_block_topk_kernel_ties_across_splits(cuda, dtype):
    """Every member block holds the same rows, so each distance occurs once
    per block, and the ties at the K'-th place span blocks that different
    blocks of pass 1 score: the kernel must keep the lowest locations, as
    the plain version's stable sort in block order does."""
    rng = np.random.default_rng(11)
    q, p, t, d, n_clusters = 2, 24, 64, 32, 6
    base = _int_rows(rng, t, d)
    pool = np.broadcast_to(base, (p, t, d)).copy()
    queries = _int_rows(rng, q, d)
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    pids[:, 40:] = -1  # 40 occupied slots a block
    live = (pids != -1).astype(np.uint8)
    owners = (np.arange(p) % n_clusters).astype(np.int32)
    probe = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    args = [_t(queries), _torch_pool(pool, dtype), _t(np.arange(p, dtype=np.int32)),
            _t(owners), _t(pids), _t(live), _t(probe)]
    args = [a.to(cuda) for a in args]
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ivf_scan.split_members(q, p, t, d, args[1].element_size(), 100, n_sm)["s"] > 1
    for kprime in (100, 37):  # 12 member blocks x 40 rows, ties at the K'-th
        kd, ki = ivf_scan.ivf_block_topk(*args, kprime=kprime)
        pd, pi = ref.ivf_block_topk_ref(*args, kprime=kprime)
        torch.cuda.synchronize()
        _agree(kd, ki, pd, pi)
        assert torch.equal(ki, pi) and torch.equal(kd, pd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivf_block_topk_kernel_occupancy_cases(cuda, dtype):
    """Member blocks with no occupied slot, with every slot occupied and
    live, with tombstones; K' above a query's occupied rows; a query whose
    probes own no candidate (all (inf, -1))."""
    rng = np.random.default_rng(12)
    q, p, t, d = 5, 8, 64, 32
    queries = rng.normal(size=(q, d)).astype(np.float32)
    pool = rng.normal(size=(p, t, d)).astype(np.float32)
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    pids[0] = -1  # no occupied slot
    pids[2, 20:] = -1
    pids[3, 5:] = -1
    live = (pids != -1).astype(np.uint8)  # block 1: every slot live
    live[2, ::3] = 0  # tombstones keep their stale id
    live[4] = 0  # every slot tombstoned
    owners = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    probe = np.array([[0, 1], [1, 2], [0, 3], [2, 3], [7, 8]], np.int32)
    args = [_t(queries), _torch_pool(pool, dtype), _t(np.arange(p, dtype=np.int32)),
            _t(owners), _t(pids), _t(live), _t(probe)]
    args = [a.to(cuda) for a in args]
    for kprime in (300, 16):
        kd, ki = ivf_scan.ivf_block_topk(*args, kprime=kprime)
        pd, pi = ref.ivf_block_topk_ref(*args, kprime=kprime)
        torch.cuda.synchronize()
        _agree(kd, ki, pd, pi)
        assert torch.isinf(kd[4]).all() and (ki[4] == -1).all()
        got = ki.cpu().numpy()
        assert (live.reshape(-1)[got[got >= 0]] == 1).all()
    assert (ki[0] >= 0).all()  # query 0 has more occupied rows than 16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivf_block_topk_kernel_sift_blocks(cuda, dtype):
    """SIFT1M's block shape (T 1024, D 128, a quarter occupied) with more
    member blocks per split than one list of occupied slots holds, so
    pass 1 compacts several groups and its candidate area fills."""
    rng = np.random.default_rng(13)
    q, p, t, d, n_clusters, np_ = 200, 40, 1024, 128, 40, 20
    queries = rng.normal(size=(q, d)).astype(np.float32)
    pool = _t(rng.normal(size=(p, t, d)).astype(np.float32)).to(getattr(torch, dtype))
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    fill = rng.integers(200, 320, p)
    for b in range(p):
        pids[b, fill[b]:] = -1
    live = (pids != -1).astype(np.uint8)
    live[rng.random((p, t)) < 0.05] = 0
    owners = rng.permutation(n_clusters)[:p].astype(np.int32)
    probe = np.stack([rng.permutation(n_clusters)[:np_] for _ in range(q)]).astype(np.int32)
    args = [a.to(cuda) for a in (_t(queries), pool, _t(np.arange(p, dtype=np.int32)),
                                 _t(owners), _t(pids), _t(live), _t(probe))]
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ivf_scan.split_members(q, p, t, d, pool.element_size(), 128, n_sm)
    assert np_ // plan["s"] > plan["list"] // t  # several groups a split
    kd, ki = ivf_scan.ivf_block_topk(*args, kprime=128)
    pd, pi = ref.ivf_block_topk_ref(*args, kprime=128)
    torch.cuda.synchronize()
    qn = (args[0] ** 2).sum(1).cpu()
    _agree(kd, ki, pd, pi, atol=1e-5 * (qn + 4 * d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivf_block_topk_kernel_rows_off_16_bytes(cuda, dtype):
    """Dim 10: rows of 40 or 20 bytes are staged by plain loads, not by
    16-byte copies."""
    queries, pool, bids, owners, pids, live, probe = _pool_inputs(dtype, seed=4, d=10)
    args = [_t(queries), _torch_pool(pool, dtype), _t(bids), _t(owners),
            _t(pids), _t(live), _t(probe)]
    args = [a.to(cuda) for a in args]
    for kprime in (128, 16):
        kd, ki = ivf_scan.ivf_block_topk(*args, kprime=kprime)
        pd, pi = ref.ivf_block_topk_ref(*args, kprime=kprime)
        torch.cuda.synchronize()
        _agree(kd, ki, pd, pi)


@pytest.mark.cuda
def test_ivf_block_topk_kernel_no_candidates(cuda):
    queries, pool, _, _, pids, live, probe = _pool_inputs("float32")
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["ivf_block_topk[float32]"]
    d, i = ivf_scan.ivf_block_topk(
        _t(queries).to(cuda), _t(pool).to(cuda), empty, empty,
        _t(pids).to(cuda), _t(live).to(cuda), _t(probe).to(cuda), kprime=32,
    )
    assert torch.isinf(d).all() and (i == -1).all()
    assert ops.launch_counts()["ivf_block_topk[float32]"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_rerank_topk_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(3)
    q, kp, d = 13, 128, 128
    queries = _t(rng.normal(size=(q, d)).astype(np.float32))
    if dtype == "int8":
        rows = _t(rng.integers(-127, 128, (q, kp, d)).astype(np.int8))
        scales = _t(rng.uniform(0.01, 0.05, (q, kp)).astype(np.float32))
    else:
        rows = _t(rng.normal(size=(q, kp, d)).astype(np.float32)).to(getattr(torch, dtype))
        scales = torch.ones((q, kp))
    loc = _t(rng.permutation(q * kp).reshape(q, kp).astype(np.int32))
    loc[_t(rng.random((q, kp)) < 0.2)] = -1
    args = [a.to(cuda) for a in (queries, rows, scales, loc)]
    kd, ki = ivf_scan.rerank_topk(*args)
    pd, pi = ref.rerank_topk_ref(*args)
    torch.cuda.synchronize()
    _agree(kd, ki, pd, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("kprime", [128, 16])
def test_ivf_block_topk_int8_kernel_matches_plain(cuda, ties, kprime):
    args = [_t(a).to(cuda) for a in _int8_inputs(seed=2, ties=ties)]
    kd, ki = ivf_scan.ivf_block_topk_int8(*args, kprime=kprime)
    pd, pi = ref.ivf_block_topk_int8_ref(*args, kprime=kprime)
    torch.cuda.synchronize()
    # the epilogue's roundings are spelled out in the kernel: same bits
    assert torch.equal(ki, pi) and torch.equal(kd, pd)


@pytest.mark.cuda
def test_ivf_block_topk_int8_kernel_many_candidates(cuda):
    """SIFT-like widths (D = 128, T = 1024) and enough candidates that
    pass 1 splits them into several chunks."""
    rng = np.random.default_rng(6)
    q, p, t, d, n_clusters, np_ = 9, 40, 1024, 128, 12, 4
    codes = _t(rng.integers(-127, 128, (p, t, d)).astype(np.int8))
    codes[7] = codes[3]  # exact ties across blocks
    scales = _t(rng.uniform(0.01, 0.05, (p, t)).astype(np.float32))
    scales[7] = scales[3]
    pids = _t(np.arange(p * t, dtype=np.int32).reshape(p, t))
    live = torch.ones((p, t), dtype=torch.uint8)
    live[:, 900:] = 0
    owners = _t(rng.integers(0, n_clusters, p).astype(np.int32))
    owners[7] = owners[3]
    probe = _t(np.stack([rng.permutation(n_clusters)[:np_] for _ in range(q)])
               .astype(np.int32))
    q_codes = _t(rng.integers(-127, 128, (q, np_, d)).astype(np.int8))
    q_meta = _t(np.stack([rng.uniform(0.01, 0.05, (q, np_)),
                          rng.uniform(100, 200, (q, np_))], -1).astype(np.float32))
    args = [a.to(cuda) for a in (q_codes, q_meta, codes, scales,
                                 torch.arange(p, dtype=torch.int32), owners,
                                 pids, live, probe)]
    kd, ki = ivf_scan.ivf_block_topk_int8(*args, kprime=128)
    pd, pi = ref.ivf_block_topk_int8_ref(*args, kprime=128)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kd, pd)


def _int8_pool(rng, p, t, d):
    codes = rng.integers(-127, 128, (p, t, d)).astype(np.int8)
    scales = rng.uniform(0.01, 0.05, (p, t)).astype(np.float32)
    return codes, scales


def _int8_queries(rng, q, np_, d):
    q_codes = rng.integers(-127, 128, (q, np_, d)).astype(np.int8)
    sq = rng.uniform(0.01, 0.05, (q, np_)).astype(np.float32)
    qn = (sq * sq) * np.sum(q_codes.astype(np.int32) ** 2, axis=-1).astype(np.float32)
    return q_codes, np.stack([sq, qn], axis=-1).astype(np.float32)


def _int8_run(cuda, args, kprime):
    """The kernel against the plain version: the same bits (the epilogue's
    roundings are spelled out in both, the integer sums are exact)."""
    args = [_t(a).to(cuda) for a in args]
    kd, ki = ivf_scan.ivf_block_topk_int8(*args, kprime=kprime)
    pd, pi = ref.ivf_block_topk_int8_ref(*args, kprime=kprime)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    return kd, ki


@pytest.mark.cuda
def test_ivf_block_topk_int8_kernel_ties_across_splits(cuda):
    """Every member block holds the same codes and scales, so each score
    occurs once per block, and the ties at the K'-th place span blocks that
    different blocks of pass 1 score: the lowest locations must win."""
    rng = np.random.default_rng(21)
    q, p, t, d, n_clusters = 2, 24, 64, 32, 6
    codes, scales = _int8_pool(rng, 1, t, d)
    codes = np.broadcast_to(codes, (p, t, d)).copy()
    scales = np.broadcast_to(scales, (p, t)).copy()
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    pids[:, 40:] = -1  # 40 occupied slots a block
    live = (pids != -1).astype(np.uint8)
    owners = (np.arange(p) % n_clusters).astype(np.int32)
    probe = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    q_codes, q_meta = _int8_queries(rng, q, 3, d)
    q_codes[:] = q_codes[:, :1]  # one residual for every probe slot
    q_meta[:] = q_meta[:, :1]
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ivf_scan.split_members_int8(q, p, t, d, 100, n_sm)["s"] > 1
    args = (q_codes, q_meta, codes, scales, np.arange(p, dtype=np.int32),
            owners, pids, live, probe)
    for kprime in (100, 37):  # 12 member blocks x 40 rows, ties at the K'-th
        kd, ki = _int8_run(cuda, args, kprime)
        assert (ki >= 0).all()


@pytest.mark.cuda
def test_ivf_block_topk_int8_kernel_occupancy_cases(cuda):
    """Member blocks with no occupied slot, every slot occupied and live,
    tombstones, every slot tombstoned, one live row; K' above a query's
    occupied rows; a query whose probes own no candidate (all (inf, -1))."""
    rng = np.random.default_rng(22)
    q, p, t, d = 5, 8, 64, 32
    codes, scales = _int8_pool(rng, p, t, d)
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    pids[0] = -1  # no occupied slot
    pids[2, 20:] = -1
    pids[3, 5:] = -1
    live = (pids != -1).astype(np.uint8)  # block 1: every slot live
    live[2, ::3] = 0  # tombstones keep their stale id
    live[4] = 0  # every slot tombstoned
    live[5] = 0
    live[5, 17] = 1  # one live row
    owners = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    probe = np.array([[0, 1], [1, 2], [0, 3], [2, 3], [7, 8]], np.int32)
    q_codes, q_meta = _int8_queries(rng, q, 2, d)
    args = (q_codes, q_meta, codes, scales, np.arange(p, dtype=np.int32),
            owners, pids, live, probe)
    for kprime in (300, 16):
        kd, ki = _int8_run(cuda, args, kprime)
        assert torch.isinf(kd[4]).all() and (ki[4] == -1).all()
        got = ki.cpu().numpy()
        assert (live.reshape(-1)[got[got >= 0]] == 1).all()
    assert (ki[0] >= 0).all()  # query 0 has more occupied rows than 16


@pytest.mark.cuda
def test_ivf_block_topk_int8_kernel_sift_blocks(cuda):
    """SIFT1M's block shape (T 1024, D 128, a quarter occupied), exact ties
    across blocks, and more member blocks per split than one group holds,
    so pass 1 lists several groups and its candidate area fills."""
    rng = np.random.default_rng(23)
    q, p, t, d, n_clusters, np_ = 64, 40, 1024, 128, 40, 32
    codes, scales = _int8_pool(rng, p, t, d)
    codes[7], scales[7] = codes[3], scales[3]
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    fill = rng.integers(200, 320, p)
    for b in range(p):
        pids[b, fill[b]:] = -1
    pids[7] = np.where(pids[3] >= 0, pids[3] + (7 - 3) * t, -1)
    live = (pids != -1).astype(np.uint8)
    live[rng.random((p, t)) < 0.05] = 0
    live[7] = live[3]
    owners = rng.permutation(n_clusters)[:p].astype(np.int32)
    owners[7] = owners[3]  # one probe slot: the same query row meets both
    probe = np.stack([rng.permutation(n_clusters)[:np_] for _ in range(q)]).astype(np.int32)
    q_codes, q_meta = _int8_queries(rng, q, np_, d)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ivf_scan.split_members_int8(q, p, t, d, 128, n_sm)
    assert np_ // plan["s"] > plan["grp"]  # several groups a split
    _int8_run(cuda, (q_codes, q_meta, codes, scales, np.arange(p, dtype=np.int32),
                     owners, pids, live, probe), 128)


@pytest.mark.cuda
@pytest.mark.parametrize("kprime", [128, 16])
def test_ivf_block_topk_int8_kernel_rows_off_16_bytes(cuda, kprime):
    """Dim 36: rows of 36 bytes are staged and scored in 4-byte words, not
    by 16-byte copies."""
    _int8_run(cuda, _int8_inputs(seed=5, d=36), kprime)


@pytest.mark.cuda
def test_ivf_block_topk_int8_kernel_no_candidates(cuda):
    q_codes, q_meta, codes, scales, _, _, pids, live, probe = _int8_inputs()
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["ivf_block_topk_int8"]
    d, i = ivf_scan.ivf_block_topk_int8(
        *[_t(a).to(cuda) for a in (q_codes, q_meta, codes, scales)], empty, empty,
        *[_t(a).to(cuda) for a in (pids, live, probe)], kprime=32,
    )
    assert torch.isinf(d).all() and (i == -1).all()
    assert ops.launch_counts()["ivf_block_topk_int8"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d,nprobe,dup", [
    (5, 1, 16, 1, False),  # one centroid
    (13, 31, 16, 31, True),  # nprobe = N, duplicated centroids
    (70, 4000, 128, 32, False),  # Q not a multiple of the query tile
    (100, 4000, 128, 32, True),
    (9, 20_000, 64, 40, True),
    (64, 20_000, 64, 20_000 // 128, False),  # a wide nprobe
    (11, 3000, 10, 16, True),  # dim 10: slices staged by 4-byte copies
])
def test_coarse_topk_kernel_query_tiles_and_ties(cuda, q, n, d, nprobe, dup):
    """Query tiles, one centroid, nprobe = N, duplicated centroids (ties go
    to the lower id) and dims off the 16-byte copies, against the plain
    version."""
    queries, cents = _coarse_inputs(q, n, d, seed=n + q, dup=dup)
    args = (_t(queries).to(cuda), _t(cents).to(cuda))
    before = ops.launch_counts()["coarse_topk"]
    ki, kd = ivf_scan.coarse_topk(*args, nprobe=nprobe)
    pi, pd = ref.coarse_topk_ref(*args, nprobe=nprobe)
    torch.cuda.synchronize()
    assert ops.launch_counts()["coarse_topk"] == before + 1
    _agree(kd, ki, pd, pi)
    if dup:
        assert torch.equal(ki, pi)
    assert ki.shape == (q, nprobe) and (ki >= 0).all() and (ki < n).all()


def _churn_on(device):
    """A scripted insert / delete / update / compaction sequence through
    the port's steps on one device; returns the final state."""
    from repro_torch.core import block_pool, insert, mutate, rearrange

    cfg = block_pool.PoolConfig(n_clusters=8, dim=16, block_size=16,
                                n_blocks=60, max_chain=12, dtype="int8")
    rng = np.random.default_rng(1)
    modes = rng.normal(size=(8, 16)).astype(np.float32) * 3
    state = block_pool.init_state(cfg, _t(modes), device)
    x = modes[rng.integers(0, 8, 600)] + rng.normal(size=(600, 16)).astype(np.float32)
    state = insert.make_insert_fn(cfg)(state, _t(x), torch.arange(600, dtype=torch.int32))
    dead = _t(rng.choice(600, 250, replace=False).astype(np.int32))
    state = mutate.make_delete_fn(cfg)(state, dead)
    upd = _t(np.concatenate([rng.choice(600, 30), [700, 701]]).astype(np.int32))
    state = mutate.make_update_fn(cfg)(state, _t(x[:32] + 0.5), upd)
    step = rearrange.make_rearrange_fn(cfg, threshold=30, dead_frac=0.3)
    for _ in range(64):
        state, triggered = step(state)
        if not triggered:
            break
    block_pool.check_invariants(state, cfg)
    return state


@pytest.mark.cuda
def test_mutation_lane_on_the_card_matches_the_cpu(cuda):
    from repro_torch.core.block_pool import IVFState
    import dataclasses

    on_card, on_cpu = _churn_on(cuda), _churn_on("cpu")
    for f in dataclasses.fields(IVFState):
        a, b = getattr(on_card, f.name).cpu(), getattr(on_cpu, f.name)
        assert torch.equal(a, b), f.name


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("kprime", [128, 16])
def test_ivf_pq_block_topk_kernel_matches_plain(cuda, ties, kprime):
    args = [_t(a).to(cuda) for a in _pq_inputs(seed=3, ties=ties)]
    kd, ki = ivf_scan.ivf_pq_block_topk(*args, kprime=kprime)
    pd, pi = ref.ivf_pq_block_topk_ref(*args, kprime=kprime)
    torch.cuda.synchronize()
    # both add the M table entries in the order j = 0..M-1: same bits
    assert torch.equal(ki, pi) and torch.equal(kd, pd)


@pytest.mark.cuda
def test_ivf_pq_block_topk_kernel_many_candidates(cuda):
    """The DSSM deployment's widths (M = 16, T = 1024), quarter-full
    blocks, exact ties across blocks, and enough candidates that pass 1
    splits each query's members over several blocks."""
    lut, codes, ids, owners, pids, live, probe = _pq_inputs(
        seed=4, q=9, npb=8, m=16, p=60, t=1024, c=60, ncl=24)
    ids = np.arange(60, dtype=np.int32)  # ascending, as the union gives them
    owners = np.random.default_rng(4).integers(0, 24, 60).astype(np.int32)
    codes[7], owners[7] = codes[3], owners[3]
    pids[:, 256:] = -1
    args = [_t(a).to(cuda) for a in (lut, codes, ids, owners, pids, live, probe)]
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ivf_scan.split_members_pq(9, 60, 1024, 16, 128, n_sm)["s"] > 1
    kd, ki = ivf_scan.ivf_pq_block_topk(*args, kprime=128)
    pd, pi = ref.ivf_pq_block_topk_ref(*args, kprime=128)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kd, pd)


def _pq_run(cuda, args, kprime, plan=None):
    """The PQ kernel against its plain version: the same bits (both add the
    M table entries in the order j = 0..M-1).  ``plan``: fields the
    wrapper's plan must have at these shapes."""
    lut, codes, ids, owners, pids, live, probe = [
        a if isinstance(a, torch.Tensor) else _t(a).to(cuda) for a in args]
    if plan:
        n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
        got = ivf_scan.split_members_pq(lut.shape[0], ids.shape[0], codes.shape[1],
                                        codes.shape[2], kprime, n_sm)
        assert {k: got[k] for k in plan} == plan, got
    before = ops.launch_counts()["ivf_pq_block_topk"]
    kd, ki = ivf_scan.ivf_pq_block_topk(lut, codes, ids, owners, pids, live, probe,
                                        kprime=kprime)
    pd, pi = ref.ivf_pq_block_topk_ref(lut, codes, ids, owners, pids, live, probe,
                                       kprime=kprime)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ivf_pq_block_topk"] == before + 1
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    return kd, ki


@pytest.mark.cuda
@pytest.mark.parametrize("kprime", [300, 16])
def test_ivf_pq_block_topk_kernel_occupancy_cases(cuda, kprime):
    """Member blocks with no occupied slot, every slot occupied and live,
    tombstones, every slot tombstoned, one live row; K' above a query's
    live rows; a query whose probes own no candidate (all (inf, -1))."""
    rng = np.random.default_rng(31)
    q, npb, m, p, t = 5, 2, 16, 8, 64
    lut = (rng.normal(size=(q, npb, m, 256)) ** 2).astype(np.float32)
    codes = rng.integers(0, 256, (p, t, m)).astype(np.uint8)
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    pids[0] = -1  # no occupied slot
    pids[2, 20:] = -1
    pids[3, 5:] = -1
    live = (pids != -1).astype(np.uint8)  # block 1: every slot live
    live[2, ::3] = 0  # tombstones keep their stale id
    live[4] = 0  # every slot tombstoned
    live[5] = 0
    live[5, 17] = 1  # one live row
    owners = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    probe = np.array([[0, 1], [1, 2], [0, 3], [2, 3], [7, 8]], np.int32)
    kd, ki = _pq_run(cuda, (lut, codes, np.arange(p, dtype=np.int32), owners,
                            pids, live, probe), kprime)
    assert torch.isinf(kd[4]).all() and (ki[4] == -1).all()
    got = ki.cpu().numpy()
    assert (live.reshape(-1)[got[got >= 0]] == 1).all()
    if kprime == 300:  # fewer live rows than K': the rest is (inf, -1)
        assert (ki[3] == -1).sum() == kprime - live[4:].sum()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 16, 12, 7, 32])
def test_ivf_pq_block_topk_kernel_chains_and_widths(cuda, m):
    """Lists whose chains span three blocks, side by side in the candidate
    list (a group of blocks under one staged table) or spread over it, rows
    of M = 8, 12, 7 bytes (4- and 1-byte staging) and of 16 and 32 (16-byte
    cp.async), and enough member blocks that each query's are split."""
    rng = np.random.default_rng(40 + m)
    q, npb, p, t, ncl = 12, 6, 48, 128, 16
    lut = (rng.normal(size=(q, npb, m, 256)) ** 2).astype(np.float32)
    codes = rng.integers(0, 256, (p, t, m)).astype(np.uint8)
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    fill = rng.integers(0, t + 1, p)
    for b in range(p):
        pids[b, fill[b]:] = -1
    live = (pids != -1).astype(np.uint8)
    live[rng.random((p, t)) < 0.1] = 0
    owners = np.concatenate([np.arange(24) // 3,  # lists 0-7: adjacent chains
                             8 + np.arange(24) % 8]).astype(np.int32)  # 8-15: spread
    probe = np.stack([rng.permutation(ncl)[:npb] for _ in range(q)]).astype(np.int32)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ivf_scan.split_members_pq(q, p, t, m, 128, n_sm)["s"] > 1
    args = (lut, codes, np.arange(p, dtype=np.int32), owners, pids, live, probe)
    before = ops.launch_counts()["ivf_pq_block_topk"]
    for kprime in (128, 37):
        _pq_run(cuda, args, kprime)
    assert ops.launch_counts()["ivf_pq_block_topk"] == before + 2


@pytest.mark.cuda
def test_ivf_pq_block_topk_kernel_unaligned_views(cuda):
    """A pool view one byte off its allocation (rows staged a byte at a
    time) and a table view one float off (cloned once, the tables are
    staged by 16-byte copies)."""
    lut, codes, ids, owners, pids, live, probe = _pq_inputs(seed=6, m=16)
    flat = torch.zeros(codes.size + 1, dtype=torch.uint8, device=cuda)
    pool = flat[1:].view(codes.shape)
    pool.copy_(_t(codes).to(cuda))
    assert pool.data_ptr() % 16 and pool.is_contiguous()
    flat_lut = torch.zeros(lut.size + 1, dtype=torch.float32, device=cuda)
    tables = flat_lut[1:].view(lut.shape)
    tables.copy_(_t(lut).to(cuda))
    assert tables.data_ptr() % 16
    args = [tables, pool] + [_t(a).to(cuda) for a in (ids, owners, pids, live, probe)]
    for kprime in (128, 16):
        _pq_run(cuda, args, kprime)


@pytest.mark.cuda
def test_ivf_pq_block_topk_kernel_ties_across_splits(cuda):
    """Every member block holds the same codes and every probe slot the same
    table, so each score occurs once per block, and the ties at the K'-th
    place span blocks that different blocks of pass 1 score: the lowest
    locations must win, as in the plain version's two-key sort."""
    rng = np.random.default_rng(32)
    q, npb, m, p, t, ncl = 2, 3, 16, 24, 64, 6
    lut = (rng.normal(size=(q, 1, m, 256)) ** 2).astype(np.float32)
    lut = np.broadcast_to(lut, (q, npb, m, 256)).copy()
    codes = np.broadcast_to(rng.integers(0, 256, (1, t, m)), (p, t, m)).astype(np.uint8).copy()
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    pids[:, 40:] = -1  # 40 occupied slots a block
    live = (pids != -1).astype(np.uint8)
    owners = (np.arange(p) % ncl).astype(np.int32)
    probe = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ivf_scan.split_members_pq(q, p, t, m, 100, n_sm)["s"] > 1
    args = (lut, codes, np.arange(p, dtype=np.int32), owners, pids, live, probe)
    for kprime in (100, 37):  # 12 member blocks x 40 rows, ties at the K'-th
        kd, ki = _pq_run(cuda, args, kprime)
        assert (ki >= 0).all()
        # equal distances come back in location order
        same = kd[:, 1:] == kd[:, :-1]
        assert same.any() and (ki[:, 1:][same] > ki[:, :-1][same]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("q,npb,m,p,t,kprime,nt", [
    (4, 3, 200, 6, 1024, 128, 1),  # one staged table: two do not fit
    (2, 2, 150, 4, 4096, 4096, 0),  # no table fits beside 8192 keys
])
def test_ivf_pq_block_topk_kernel_table_fallbacks(cuda, q, npb, m, p, t, kprime, nt):
    """Shapes the first design's wrapper took whose tables do not fit in
    pairs (nt 1) or at all (nt 0, gathered from device memory)."""
    rng = np.random.default_rng(33 + nt)
    lut = (rng.normal(size=(q, npb, m, 256)) ** 2).astype(np.float32)
    codes = rng.integers(0, 256, (p, t, m)).astype(np.uint8)
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    pids[:, 3 * t // 4 :] = -1
    live = (pids != -1).astype(np.uint8)
    live[rng.random((p, t)) < 0.1] = 0
    owners = (np.arange(p) % (npb + 1)).astype(np.int32)
    probe = np.stack([rng.permutation(npb + 1)[:npb] for _ in range(q)]).astype(np.int32)
    _pq_run(cuda, (lut, codes, np.arange(p, dtype=np.int32), owners, pids, live, probe),
            kprime, plan={"nt": nt})


@pytest.mark.cuda
@pytest.mark.parametrize("offset,ub", [(0, 16), (4, 4), (1, 1)])
def test_ivf_pq_block_topk_kernel_untabled_units(cuda, offset, ub):
    """The tables read from device memory (nt 0: K' = 8192 leaves no room
    for one of M = 128 beside the keys) with code rows staged by 16-, 4-
    and 1-byte units (a pool 0, 4 or 1 byte off 16): the instantiations
    <16, false>, <4, false> and <1, false> of pass 1."""
    rng = np.random.default_rng(34 + offset)
    q, npb, m, p, t, kprime = 2, 2, 128, 4, 1024, 8192
    lut = (rng.normal(size=(q, npb, m, 256)) ** 2).astype(np.float32)
    codes = rng.integers(0, 256, (p, t, m)).astype(np.uint8)
    pids = np.arange(p * t, dtype=np.int32).reshape(p, t)
    pids[:, 3 * t // 4 :] = -1
    live = (pids != -1).astype(np.uint8)
    live[rng.random((p, t)) < 0.1] = 0
    owners = (np.arange(p) % (npb + 1)).astype(np.int32)
    probe = np.stack([rng.permutation(npb + 1)[:npb] for _ in range(q)]).astype(np.int32)
    flat = torch.zeros(codes.size + offset, dtype=torch.uint8, device=cuda)
    pool = flat[offset:].view(codes.shape)
    pool.copy_(_t(codes).to(cuda))
    got_ub = 16 if pool.data_ptr() % 16 == 0 else 4 if pool.data_ptr() % 4 == 0 else 1
    assert got_ub == ub
    args = [_t(lut).to(cuda), pool] + [_t(a).to(cuda) for a in (
        np.arange(p, dtype=np.int32), owners, pids, live, probe)]
    _pq_run(cuda, args, kprime, plan={"nt": 0})


def _rerank_inputs(rng, dtype, q, kp, d, ties=False):
    """Survivor rows of each dtype with a fifth of the locations -1; with
    ``ties``, small integer rows repeated in each query (every distance
    exact in any order of sums), so equal distances meet."""
    if ties:
        queries = rng.integers(-3, 4, (q, d)).astype(np.float32)
        base = rng.integers(-3, 4, (q, kp // 4 + 1, d))
        rows = base[:, rng.integers(0, kp // 4 + 1, kp)]
        scales = np.ones((q, kp), np.float32)
        rows = _t(np.ascontiguousarray(rows, np.int8 if dtype == "int8" else np.float32))
    else:
        queries = rng.normal(size=(q, d)).astype(np.float32)
        if dtype == "int8":
            rows = _t(rng.integers(-127, 128, (q, kp, d)).astype(np.int8))
            scales = rng.uniform(0.01, 0.05, (q, kp)).astype(np.float32)
        else:
            rows = _t(rng.normal(size=(q, kp, d)).astype(np.float32))
            scales = np.ones((q, kp), np.float32)
    if dtype != "int8":
        rows = rows.to(getattr(torch, dtype))
    loc = rng.permutation(q * kp).reshape(q, kp).astype(np.int32)
    loc[rng.random((q, kp)) < 0.2] = -1
    return [_t(queries), rows, _t(scales), _t(loc)]


def _rerank_run(cuda, args, exact=False):
    name = f"rerank_topk[{args[1].dtype}".replace("torch.", "") + "]"
    before = ops.launch_counts()[name]
    kd, ki = ivf_scan.rerank_topk(*args)
    pd, pi = ref.rerank_topk_ref(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    _agree(kd, ki, pd, pi)
    if exact:  # exact distances: ties by location, the same bits
        assert torch.equal(ki, pi) and torch.equal(kd, pd)
    valid = (args[3] != -1).sum(1)
    assert ((ki != -1).sum(1) == valid).all()
    return kd, ki


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kp", [100, 128, 256])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_rerank_topk_kernel_widths(cuda, dtype, kp, d):
    """K' off and on powers of two, rows of 64, 96 and 128 values (lanes a
    row: 16/24/32 of 32 in float32, 8/12/16 in bfloat16, 4/6/8 in int8),
    locations of -1, within the tie rule; then exact ties."""
    rng = np.random.default_rng(kp + d)
    _rerank_run(cuda, [a.to(cuda) for a in _rerank_inputs(rng, dtype, 7, kp, d)])
    _rerank_run(cuda, [a.to(cuda) for a in _rerank_inputs(rng, dtype, 7, kp, d, ties=True)],
                exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kp,d", [(128, 10), (37, 36), (1500, 16), (1, 128)])
def test_rerank_topk_kernel_scalar_path_and_long_lists(cuda, dtype, kp, d):
    """Rows whose bytes do not fill 16-byte units (the scalar path: dim 10;
    dim 36 in bfloat16 and int8, where float32 rows are 9 units a row), a K'
    above the rank merge's (a bitonic sort in shared memory) and a K' of
    one."""
    rng = np.random.default_rng(kp * d)
    for ties in (False, True):
        args = [a.to(cuda) for a in _rerank_inputs(rng, dtype, 5, kp, d, ties=ties)]
        _rerank_run(cuda, args, exact=ties)


@pytest.mark.cuda
def test_rerank_topk_kernel_unaligned_rows(cuda):
    """Rows one float off a 16-byte boundary take the scalar path."""
    rng = np.random.default_rng(9)
    queries, rows, scales, loc = _rerank_inputs(rng, "float32", 6, 128, 128)
    flat = torch.zeros(rows.numel() + 1, device=cuda)
    view = flat[1:].view(rows.shape)
    view.copy_(rows.to(cuda))
    assert view.data_ptr() % 16
    _rerank_run(cuda, [queries.to(cuda), view, scales.to(cuda), loc.to(cuda)])


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,m,ties", [
    (6, 40, 8, False), (6, 40, 8, True), (64, 5000, 16, False),
])
def test_pq_adc_kernel_matches_plain(cuda, r, n, m, ties):
    lut, codes = (_t(a).to(cuda) for a in _adc_inputs(seed=r, r=r, n=n, m=m, ties=ties))
    before = ops.launch_counts()["pq_adc"]
    got = pq_adc.pq_adc(lut, codes)
    want = ref.pq_adc_ref(lut, codes)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.launch_counts()["pq_adc"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,p,t,d,c", [
    (13, 12, 16, 16, None),  # ragged tiles, hole candidates (-1)
    (64, 48, 1024, 128, 40),  # SIFT1M's union widths
    (70, 9, 100, 40, 9),  # two query tiles, T and D off the tile sizes
])
def test_ivf_block_scan_kernel_matches_plain(cuda, dtype, q, p, t, d, c):
    rng = np.random.default_rng(q + t)
    if c is None:
        queries, pool, bids, *_ = _pool_inputs(dtype, seed=7)
    else:
        queries = rng.normal(size=(q, d)).astype(np.float32)
        pool = rng.normal(size=(p, t, d)).astype(np.float32)
        bids = rng.permutation(p)[:c].astype(np.int32)
    args = (_t(queries).to(cuda), _torch_pool(pool, dtype).to(cuda),
            _t(bids).to(cuda))
    name = f"ivf_block_scan[{dtype}]"
    before = ops.launch_counts()[name]
    got = ivf_scan.ivf_block_scan(*args)
    want = ref.ivf_block_scan_ref(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    assert got.shape == want.shape == (len(bids), queries.shape[0], pool.shape[1])
    # float32 sums in another order than the plain version's matmul
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _scan_run(cuda, dtype, queries, pool, bids, pool_view=None):
    """ivf_block_scan on the card against its plain version on the same
    inputs, one launch counted; ``pool_view`` (a CUDA tensor holding
    ``pool``'s values) replaces the plain copy on the kernel's side."""
    args = (_t(queries).to(cuda), _torch_pool(pool, dtype).to(cuda), _t(bids).to(cuda))
    if pool_view is not None:
        args = (args[0], pool_view, args[2])
    name = f"ivf_block_scan[{dtype}]"
    before = ops.launch_counts()[name]
    got = ivf_scan.ivf_block_scan(*args)
    want = ref.ivf_block_scan_ref(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    assert got.shape == want.shape == (len(bids), queries.shape[0], pool.shape[1])
    # float32 sums in another order than the plain version's matmul
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _scan_inputs(seed, q, p, t, d, c, holes=True):
    rng = np.random.default_rng(seed)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    pool = rng.normal(size=(p, t, d)).astype(np.float32)
    bids = rng.integers(0, p, size=(c,)).astype(np.int32)
    if holes:
        bids[rng.random(c) < 0.3] = -1
    return queries, pool, bids


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [13, 40, 128, 136, 256])
def test_ivf_block_scan_kernel_widths(cuda, dtype, d):
    """Dims off a stage (13, 40: zero-filled; 136: a stage and a part),
    one and several stages, with hole candidates (-1): rows of 13 floats
    and of 13 bf16 values are off 16 bytes and take the narrow copies."""
    _scan_run(cuda, dtype, *_scan_inputs(d, 65, 6, 100, d, 9))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", [1, 64, 65, 200])
@pytest.mark.parametrize("t", [1, 100, 1024])
def test_ivf_block_scan_kernel_tiles(cuda, dtype, q, t):
    """Query tiles full, ragged and several (grid y), row tiles of one row,
    a partial tile and four tiles a candidate, over more items than the
    workers take at once (C = 300 at T = 1, 60 at T = 100)."""
    c = {1: 300, 100: 60, 1024: 5}[t]
    _scan_run(cuda, dtype, *_scan_inputs(q * t, q, 8, t, 40, c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bid", [3, -1])
def test_ivf_block_scan_kernel_one_candidate(cuda, dtype, bid):
    """C = 1: one worker, one candidate (a hole reads block 0)."""
    queries, pool, _ = _scan_inputs(5, 64, 4, 1024, 128, 1)
    _scan_run(cuda, dtype, queries, pool, np.array([bid], np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,offset", [(13, "row"), (42, "row"), (128, "value"),
                                      (40, "value")])
def test_ivf_block_scan_kernel_unaligned_pool(cuda, dtype, d, offset):
    """A pool view one row (of 13 or 42 values) or one value past a
    16-byte boundary: its rows are not 16-byte aligned, so they are copied
    4 bytes at a time (bf16 rows of 42 values), or 2 (bf16 rows off 4
    bytes)."""
    queries, pool, bids = _scan_inputs(d + 1, 70, 5, 100, d, 12)
    host = _torch_pool(pool, dtype)
    skip = d if offset == "row" else 1
    flat = torch.zeros(host.numel() + skip, dtype=host.dtype, device=cuda)
    view = flat[skip:].view(host.shape)
    view.copy_(host.to(cuda))
    assert view.data_ptr() % 16
    _scan_run(cuda, dtype, queries, pool, bids, pool_view=view)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 700), ("bfloat16", 1300)])
def test_ivf_block_scan_kernel_query_slabs(cuda, dtype, d):
    """Dims too many for the query tile beside the ring: it is held in
    slabs (608 float32 dims, 1216 bf16) restaged per item."""
    slab = ivf_scan.plan_block_scan(64, 7, 300, d, 4 if dtype == "float32" else 2,
                                    132)["slab"]
    assert slab < d
    _scan_run(cuda, dtype, *_scan_inputs(d, 64, 5, 300, d, 7))


def _adc_run(lut, codes):
    """pq_adc on the card, bit-equal to its plain version, one launch."""
    before = ops.launch_counts()["pq_adc"]
    got = pq_adc.pq_adc(lut, codes)
    want = ref.pq_adc_ref(lut, codes)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pq_adc"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 16, 32, 64, 225])
@pytest.mark.parametrize("n", [1, 31, 1024, 2049, 5000])
def test_pq_adc_kernel_widths_and_lengths(cuda, m, n):
    """Every load width (16-byte rows at M 16, 32, 64; 4-byte at M 8; bytes
    at M 1, 3, 225), tables up to the shared-memory limit (M 225) and rows
    a table from one to chunks of several blocks."""
    lut, codes = (_t(a).to(cuda) for a in _adc_inputs(seed=m * n, r=3, n=n, m=m))
    _adc_run(lut, codes)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 16, 225])
@pytest.mark.parametrize("what", ["codes", "lut"])
def test_pq_adc_kernel_unaligned_views(cuda, m, what):
    """Codes sliced to an odd byte offset (1-byte loads), or tables one
    float off 16 bytes (4-byte copies)."""
    lut, codes = (_t(a).to(cuda) for a in _adc_inputs(seed=m, r=5, n=700, m=m))
    src = codes if what == "codes" else lut
    flat = torch.zeros(src.numel() + 1, dtype=src.dtype, device=cuda)
    view = flat[1:].view(src.shape)
    view.copy_(src)
    assert view.data_ptr() % (2 if what == "codes" else 16)
    if what == "codes":
        _adc_run(lut, view)
    else:
        _adc_run(view, codes)


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(2048, 2048), (2048, 1024), (1000, 1024),
                                 (600, 3000)])
def test_pq_adc_kernel_tied_tables_at_served_shapes(cuda, r, n):
    """block_table's (2048 x 2048) and chain_walk's (2048 x 1024) shapes,
    where a block takes several tables in turn, restaging its one table
    buffer, and runs that do not divide evenly; every table equal and the
    codes tied, so equal sums must come out equal."""
    lut, codes = _adc_inputs(seed=r + n, r=r, n=n, m=16, ties=True)
    lut[:] = lut[0]
    _adc_run(_t(lut).to(cuda), _t(codes).to(cuda))
    lut, codes = _adc_inputs(seed=r * n, r=r, n=n, m=16)
    _adc_run(_t(lut).to(cuda), _t(codes).to(cuda))


def _paged_inputs(b, h, kvh, dh, t, nb, seed, lengths=None):
    """The reference's kernel-test layout: each sequence owns nb blocks of
    a shuffled pool, -1 table entries past its end; random lengths with one
    empty and one full sequence unless ``lengths`` is given."""
    rng = np.random.default_rng(seed)
    p = nb * b + 2
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    kp = rng.normal(size=(p, t, kvh, dh)).astype(np.float32)
    vp = rng.normal(size=(p, t, kvh, dh)).astype(np.float32)
    perm = rng.permutation(p)[: b * nb].reshape(b, nb).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(0, nb * t + 1, size=(b,)).astype(np.int32)
        lengths[0] = 0
        if b > 1:
            lengths[1] = nb * t
    lengths = np.asarray(lengths, np.int32)
    tables = np.where(np.arange(nb)[None, :] * t < np.maximum(lengths, 1)[:, None],
                      perm, -1).astype(np.int32)
    return q, kp, vp, tables, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,dh,t,nb", [
    (2, 8, 2, 64, 16, 4),  # GQA
    (1, 4, 4, 128, 32, 2),  # MHA (G=1)
    (3, 8, 1, 64, 8, 5),  # MQA (G=8)
    (5, 6, 2, 48, 16, 3),  # G=3, dh off the warp width
    (16, 32, 8, 128, 16, 36),  # llama3-8b serving: 576 positions
])
def test_paged_decode_attention_kernel_matches_plain(cuda, dtype, b, h, kvh, dh, t, nb):
    from repro_torch.kernels import paged_attention

    q, kp, vp, tables, lengths = _paged_inputs(b, h, kvh, dh, t, nb, seed=b * 10 + h)
    td = getattr(torch, dtype)
    args = [_t(a).to(cuda, td) for a in (q, kp, vp)] + [_t(tables).to(cuda),
                                                        _t(lengths).to(cuda)]
    before = ops.launch_counts()["paged_decode_attention"]
    got = paged_attention.paged_decode_attention(*args)
    want = ref.paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    assert got.dtype == td and got.shape == (b, h, dh)
    assert (got[0] == 0).all()  # length 0 writes zeros
    # float32: sums in another order; bf16: the plain version rounds the
    # logits and weights to bf16 (the reference's oracle), the kernel not
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        # the plain version in float32 on the same bf16 values, rounded to
        # bf16 as the kernel rounds its float32 result: one bf16 unit in the
        # last place at most (2^-7 of the value), 1e-2 of the RMS near 0
        f32 = ref.paged_decode_attention_ref(*[a.float() for a in args[:3]],
                                             *args[3:]).to(td).float()
        rms = float(f32.pow(2).mean().sqrt())
        torch.testing.assert_close(got.float(), f32, rtol=2.0**-7, atol=1e-2 * rms)


def _paged_check(got, args, dtype):
    """The kernel against the plain version run in float32 on the same
    values: float32 within 2e-5 (sums in another order); bf16 within one
    bf16 unit in the last place (2^-7 of the value), 1e-2 of the RMS near 0."""
    want = ref.paged_decode_attention_ref(*[a.float() for a in args[:3]], *args[3:])
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        want = want.to(torch.bfloat16).float()
        rms = float(want.pow(2).mean().sqrt())
        torch.testing.assert_close(got.float(), want, rtol=2.0**-7, atol=1e-2 * rms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 3, 8])
def test_paged_decode_attention_split_edges(cuda, dtype, g):
    """Lengths at the planner's split edges: 0 beside full tables, 1, one
    split exactly, one position past it, two splits, one short of full;
    -1 table entries past each length."""
    from repro_torch.kernels import paged_attention

    b, kvh, dh, t, nb = 7, 2, 64, 16, 96
    td = getattr(torch, dtype)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = paged_attention.plan_splits(b, kvh, g, nb, t, dh, td.itemsize, n_sm)
    edge = plan["bps"] * t
    assert plan["s"] > 2
    lengths = [0, 1, edge, edge + 1, 2 * edge, nb * t - 1, nb * t]
    q, kp, vp, tables, lengths = _paged_inputs(b, g * kvh, kvh, dh, t, nb,
                                               seed=g, lengths=lengths)
    args = [_t(a).to(cuda, td) for a in (q, kp, vp)] + [_t(tables).to(cuda),
                                                        _t(lengths).to(cuda)]
    got = paged_attention.paged_decode_attention(*args)
    split = ref.paged_decode_attention_split_ref(
        *[a.cpu() for a in args], bps=plan["bps"])
    torch.cuda.synchronize()
    assert (got[0] == 0).all()
    _paged_check(got, args, dtype)
    tol = 2e-5 if dtype == "float32" else 2.0**-7
    torch.testing.assert_close(got.float().cpu(), split.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_paged_decode_attention_many_splits(cuda):
    """2 sequences x 32,768 positions (llama3-8b's heads, bf16): tens of
    splits per (sequence, head), against the plain version in float32."""
    from repro_torch.kernels import paged_attention

    b, h, kvh, dh, t, nb = 2, 32, 8, 128, 16, 2048
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = paged_attention.plan_splits(b, kvh, h // kvh, nb, t, dh, 2, n_sm)
    assert plan["s"] >= 32
    gen = torch.Generator(device=cuda).manual_seed(3)
    kp = torch.randn((b * nb, t, kvh, dh), generator=gen, device=cuda).to(torch.bfloat16)
    vp = torch.randn((b * nb, t, kvh, dh), generator=gen, device=cuda).to(torch.bfloat16)
    q = torch.randn((b, h, dh), generator=gen, device=cuda).to(torch.bfloat16)
    tables = torch.randperm(b * nb, generator=gen, device=cuda).to(torch.int32).reshape(b, nb)
    lengths = torch.tensor([nb * t, nb * t - 5], dtype=torch.int32, device=cuda)
    args = [q, kp, vp, tables, lengths]
    got = paged_attention.paged_decode_attention(*args)
    torch.cuda.synchronize()
    _paged_check(got, args, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,dh,t,nb", [
    (3, 8, 2, 64, 64, 5),  # blocks of 64 positions
    (2, 8, 2, 128, 128, 3),  # blocks of 128
    (4, 8, 2, 64, 48, 6),  # blocks of 48: tiles straddle blocks
    (3, 32, 2, 128, 16, 9),  # G = 16: H 32 over 2 KV heads
    (2, 16, 1, 64, 64, 4),  # G = 16 and blocks of 64
    (3, 12, 1, 32, 16, 4),  # G = 12: launches of 8 and 4 heads
    (3, 2, 2, 256, 16, 5),  # heads of 256 dims, G = 1, 2, 4, 8: float32
    (3, 4, 2, 256, 16, 5),  # with two 16-byte vectors of a K row a
    (3, 8, 2, 256, 16, 5),  # thread, bf16 at its widest head
    (3, 16, 2, 256, 16, 5),
])
def test_paged_decode_attention_large_blocks_and_groups(cuda, dtype, b, h, kvh, dh, t, nb):
    """Pool blocks over 32 positions and GQA groups over 8 heads, which the
    reference serves, and heads of 256 dims, the widest the kernels take:
    against the plain version in float32 and the split-K scheme's plain
    version, and one launch count a call."""
    from repro_torch.kernels import paged_attention

    q, kp, vp, tables, lengths = _paged_inputs(b, h, kvh, dh, t, nb, seed=t + h)
    td = getattr(torch, dtype)
    args = [_t(a).to(cuda, td) for a in (q, kp, vp)] + [_t(tables).to(cuda),
                                                        _t(lengths).to(cuda)]
    before = ops.launch_counts()["paged_decode_attention"]
    got = paged_attention.paged_decode_attention(*args)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = paged_attention.plan_splits(b, kvh, h // kvh, nb, t, dh, td.itemsize, n_sm)
    split = ref.paged_decode_attention_split_ref(*[a.cpu() for a in args], bps=plan["bps"])
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    assert got.dtype == td and got.shape == (b, h, dh)
    assert (got[0] == 0).all()  # length 0 writes zeros
    _paged_check(got, args, dtype)
    tol = 2e-5 if dtype == "float32" else 2.0**-7
    torch.testing.assert_close(got.float().cpu(), split.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_attention_unaligned_q(cuda, dtype):
    """A q that is a view off a 16-byte boundary is copied once, not
    refused."""
    from repro_torch.kernels import paged_attention

    b, h, kvh, dh, t, nb = 3, 8, 2, 64, 16, 4
    q, kp, vp, tables, lengths = _paged_inputs(b, h, kvh, dh, t, nb, seed=9)
    td = getattr(torch, dtype)
    buf = torch.zeros(q.size + 1, dtype=td, device=cuda)
    qv = buf[1:].view(b, h, dh)
    qv.copy_(_t(q).to(cuda, td))
    assert qv.data_ptr() % 16 and qv.is_contiguous()
    args = [qv] + [_t(a).to(cuda, td) for a in (kp, vp)] + [_t(tables).to(cuda),
                                                            _t(lengths).to(cuda)]
    got = paged_attention.paged_decode_attention(*args)
    torch.cuda.synchronize()
    _paged_check(got, args, dtype)


@pytest.mark.cuda
def test_paged_decode_step_on_the_card_matches_the_cpu(cuda):
    """llama3-8b's smoke config through ``paged_decode_step`` on both
    devices with the same weights and tokens: every layer of every step
    launches the kernel once, and the logits agree (float32)."""
    from repro_torch.configs.llama3_8b import SMOKE
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving.paged_lm import init_paged_kv, paged_decode_step

    params = init_lm(0, SMOKE, device="cpu")
    on_card = _to(params, cuda)
    kw = dict(n_blocks=12, block_size=4, max_blocks_per_seq=5)
    s_cpu = init_paged_kv(SMOKE, 3, device="cpu", **kw)
    s_card = init_paged_kv(SMOKE, 3, device=cuda, **kw)
    toks = np.random.default_rng(0).integers(0, SMOKE.vocab, (9, 3)).astype(np.int32)
    before = ops.launch_counts()["paged_decode_attention"]
    for tok in toks:
        lg_cpu, s_cpu = paged_decode_step(params, SMOKE, _t(tok), s_cpu)
        lg_card, s_card = paged_decode_step(on_card, SMOKE, _t(tok).to(cuda), s_card)
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
    assert ops.launch_counts()["paged_decode_attention"] == before + 9 * SMOKE.n_layers
    assert torch.equal(s_card.block_tables.cpu(), s_cpu.block_tables)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_union_paths_on_the_card_match_the_cpu(cuda, dtype):
    """``union_pallas`` (the kernels) and ``union`` (plain) on the card,
    and ``union_pallas`` on the CPU, give the same ids on one index."""
    from repro_torch.core import block_pool, insert, search

    cfg = block_pool.PoolConfig(n_clusters=8, dim=32, block_size=64,
                                n_blocks=40, max_chain=8, dtype=dtype)
    rng = np.random.default_rng(2)
    modes = rng.normal(size=(8, 32)).astype(np.float32) * 3
    x = modes[rng.integers(0, 8, 1500)] + rng.normal(size=(1500, 32)).astype(np.float32)
    queries = _t(modes[rng.integers(0, 8, 20)]
                 + rng.normal(size=(20, 32)).astype(np.float32))
    out = {}
    for dev in (cuda, "cpu"):
        state = block_pool.init_state(cfg, _t(modes), dev)
        state = insert.make_insert_fn(cfg)(state, _t(x).to(dev),
                                           torch.arange(1500, dtype=torch.int32, device=dev))
        for path in ("union", "union_pallas"):
            fn = search.make_search_fn(cfg, nprobe=3, k=10, path=path)
            out[str(dev), path] = [a.cpu() for a in fn(state, queries.to(dev))]
    kd, ki = out["cuda", "union_pallas"]
    for key in (("cuda", "union"), ("cpu", "union_pallas")):
        _agree(kd, ki, *out[key])
