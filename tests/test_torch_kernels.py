"""The port's kernels against the JAX package's oracles.

Each plain PyTorch version (``repro_torch.kernels.ref``) is held to the JAX
oracle of the same name on the same numpy inputs: ids exact, distances
within rtol = atol = 1e-5 (the tolerance ``tests/test_mutation.py`` uses
for cross-implementation distances; both sides sum in float32 in different
orders).  The inputs are built in ``test_torch_kernels_cuda.py``, which
holds the hand-written kernels to the same plain versions on the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.ivf_scan import coarse_topk_scan, ivf_block_topk_scan
from repro_torch.kernels import ivf_scan, ops, ref
from test_torch_kernels_cuda import _coarse_inputs, _pool_inputs, _torch_pool

RTOL = ATOL = 1e-5

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


# -------------------------------------------- plain versions vs the JAX ----


@pytest.mark.parametrize("q,n,d,nprobe,dup", [
    (13, 37, 16, 4, False),  # N not a multiple of the reference's tile
    (13, 130, 32, 9, False),
    (7, 40, 16, 8, True),  # exact ties
])
def test_coarse_topk_ref_matches_jax(q, n, d, nprobe, dup):
    queries, cents = _coarse_inputs(q, n, d, seed=n, dup=dup)
    ti, td = ref.coarse_topk_ref(_t(queries), _t(cents), nprobe=nprobe)
    for ji, jd in (
        jref.coarse_topk_ref(_j(queries), _j(cents), nprobe=nprobe),
        coarse_topk_scan(_j(queries), _j(cents), nprobe=nprobe),
    ):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(td, jd)
    if dup:  # the lower of two equal centroids comes first
        half = n // 2
        for row in ti.numpy():
            for c in row:
                if half <= c < 2 * half:
                    assert c - half in row


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kprime", [128, 16])
def test_ivf_block_topk_ref_matches_jax(dtype, kprime):
    queries, pool, bids, owners, pids, live, probe = _pool_inputs(dtype, seed=1)
    jpool = _j(pool).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    args_j = (_j(queries), jpool, _j(bids), _j(owners), _j(pids), _j(live), _j(probe))
    args_t = (_t(queries), _torch_pool(pool, dtype), _t(bids), _t(owners),
              _t(pids), _t(live), _t(probe))
    td, ti = ref.ivf_block_topk_ref(*args_t, kprime=kprime)
    assert td.shape == (13, kprime) and ti.dtype == torch.int32
    for jd, ji in (
        jref.ivf_block_topk_ref(*args_j, kprime=kprime),
        ivf_block_topk_scan(*args_j, kprime=kprime),
    ):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(td, jd)
    if kprime == 128:  # k > live: the tail is (inf, -1)
        assert (ti == -1).any() and torch.isinf(td[ti == -1]).all()
    # nothing masked leaks out: tombstones, empty slots, non-members
    flat_live = live.reshape(-1)
    got = ti.numpy()
    assert (flat_live[got[got >= 0]] == 1).all()


def test_ivf_block_topk_ref_no_candidates():
    queries, pool, _, _, pids, live, probe = _pool_inputs("float32")
    empty = torch.zeros((0,), dtype=torch.int32)
    d, i = ref.ivf_block_topk_ref(_t(queries), _t(pool), empty, empty,
                                  _t(pids), _t(live), _t(probe), kprime=32)
    assert torch.isinf(d).all() and (i == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_rerank_topk_ref_matches_jax(dtype):
    rng = np.random.default_rng(3)
    q, kp, d = 13, 128, 16
    queries = rng.normal(size=(q, d)).astype(np.float32)
    if dtype == "int8":
        rows = rng.integers(-127, 128, (q, kp, d)).astype(np.int8)
        scales = rng.uniform(0.01, 0.05, (q, kp)).astype(np.float32)
        jrows, trows = _j(rows), _t(rows)
    else:
        rows = rng.normal(size=(q, kp, d)).astype(np.float32)
        scales = np.ones((q, kp), np.float32)
        jrows = _j(rows).astype(getattr(jnp, dtype))
        trows = _t(rows).to(getattr(torch, dtype))
    loc = rng.permutation(q * kp).reshape(q, kp).astype(np.int32)
    loc[rng.random((q, kp)) < 0.2] = -1
    td, ti = ref.rerank_topk_ref(_t(queries), trows, _t(scales), _t(loc))
    jd, ji = jref.rerank_topk_ref(_j(queries), jrows, _j(scales), _j(loc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(td, jd)
    assert (ti.numpy()[:, -1] == -1).all()


def test_cpu_dispatch_runs_plain_and_launches_nothing():
    ops.reset_launch_counts()
    queries, pool, bids, owners, pids, live, probe = _pool_inputs("float32")
    ti, _ = ops.coarse_topk(_t(queries), _t(pool[:, 0]), nprobe=3)
    d, i = ops.ivf_block_topk(_t(queries), _t(pool), _t(bids), _t(owners),
                              _t(pids), _t(live), _t(probe), kprime=32)
    rows = _t(pool).reshape(-1, 16)[torch.clamp(i, min=0).long()]
    ops.rerank_topk(_t(queries), rows, torch.ones(i.shape), i)
    assert ti.shape == (13, 3)
    assert sum(ops.launch_counts().values()) == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    queries, cents = _coarse_inputs(3, 10, 8, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        ivf_scan.coarse_topk(_t(queries), _t(cents), nprobe=2)


def test_topk_mismatches_tie_rule():
    d = torch.tensor([[1.0, 2.0, 2.0 + 1e-7, 5.0]])
    i = torch.tensor([[4, 7, 9, 1]])
    swapped = torch.tensor([[4, 9, 7, 1]])
    assert ref.topk_mismatches(d, i, d, swapped, rtol=1e-5, atol=0.0) == []
    at_boundary = torch.tensor([[4, 7, 9, 3]])  # a tie past the last column
    assert ref.topk_mismatches(d, at_boundary, d, i, rtol=1e-5, atol=0.0) == []
    wrong = torch.tensor([[4, 3, 9, 1]])
    assert ref.topk_mismatches(d, wrong, d, i, rtol=1e-5, atol=0.0)
    far = d + torch.tensor([[0.0, 0.0, 0.0, 1.0]])
    assert ref.topk_mismatches(far, i, d, i, rtol=1e-5, atol=0.0)
