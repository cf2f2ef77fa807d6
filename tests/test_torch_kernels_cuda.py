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
    """Enough candidates that pass 1 splits them into several chunks."""
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
    assert ivf_scan.split_candidates(p, q, 128, n_sm)[0] > 1
    kd, ki = ivf_scan.ivf_block_topk(*args, kprime=128)
    pd, pi = ref.ivf_block_topk_ref(*args, kprime=128)
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
    splits them into several chunks."""
    lut, codes, ids, owners, pids, live, probe = _pq_inputs(
        seed=4, q=9, npb=8, m=16, p=60, t=1024, c=60, ncl=24)
    ids = np.arange(60, dtype=np.int32)  # ascending, as the union gives them
    owners = np.random.default_rng(4).integers(0, 24, 60).astype(np.int32)
    codes[7], owners[7] = codes[3], owners[3]
    pids[:, 256:] = -1
    args = [_t(a).to(cuda) for a in (lut, codes, ids, owners, pids, live, probe)]
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ivf_scan.split_candidates(60, 9, 128, n_sm)[0] > 1
    kd, ki = ivf_scan.ivf_pq_block_topk(*args, kprime=128)
    pd, pi = ref.ivf_pq_block_topk_ref(*args, kprime=128)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kd, pd)


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
