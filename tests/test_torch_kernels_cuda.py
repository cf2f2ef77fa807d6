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

from repro_torch.kernels import ivf_scan, ops, ref

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
