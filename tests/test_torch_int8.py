"""The port's int8 payload search against the JAX package.

``ivf_block_topk_int8_ref`` (the int8 kernel's plain version) is held to
the reference's ``ivf_block_topk_int8_ref`` and ``ivf_block_topk_int8_scan``
on the same numpy inputs: ids exact, distances within rtol = atol = 1e-5
(the reference's own cross-implementation tolerance; its integer dots are
exact, its float32 epilogue may differ by ulps between XLA fusions).
``quantize_queries`` must give equal codes and meta within 1e-6.  The
inputs are built in ``test_torch_kernels_cuda.py``, which holds the CUDA
kernel to the same plain version on the card.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels import ivf_scan as jscan
from repro.kernels import ref as jref
from repro_torch.kernels import ivf_scan, ops, ref
from test_torch_kernels_cuda import _int8_inputs

RTOL = ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("kprime", [128, 16])
def test_ivf_block_topk_int8_ref_matches_jax(ties, kprime):
    inputs = _int8_inputs(seed=2, ties=ties)
    td, ti = ref.ivf_block_topk_int8_ref(*map(_t, inputs), kprime=kprime)
    assert td.shape == (13, kprime) and ti.dtype == torch.int32
    args_j = [jnp.asarray(a) for a in inputs]
    for jd, ji in (
        jref.ivf_block_topk_int8_ref(*args_j, kprime=kprime),
        jscan.ivf_block_topk_int8_scan(*args_j, kprime=kprime, chunk=4),
    ):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    live = inputs[7].reshape(-1)
    got = ti.numpy()
    assert (live[got[got >= 0]] == 1).all()  # no tombstone, empty slot leaks
    if kprime == 128:  # k > live: the tail is (inf, -1)
        assert (ti == -1).any() and torch.isinf(td[ti == -1]).all()
    if ties:  # exact ties come back in location order
        d, i = td.numpy(), got
        same = (d[:, 1:] == d[:, :-1]) & (i[:, 1:] >= 0)
        assert same.any() and (i[:, 1:][same] > i[:, :-1][same]).all()


def test_pslot_from_owners_matches_jax():
    *_, owners, _, _, probe = _int8_inputs(seed=3)
    np.testing.assert_array_equal(
        ref._pslot_from_owners(_t(probe), _t(owners)).numpy(),
        np.asarray(jref._pslot_from_owners(jnp.asarray(probe), jnp.asarray(owners))),
    )


def test_quantize_queries_matches_jitted_reference():
    x = np.random.default_rng(1).normal(size=(13, 4, 32)).astype(np.float32) * 5
    x[0, 0] = 0.0  # an all-zero residual keeps a representable scale
    jc, jm = jax.jit(jscan.quantize_queries)(jnp.asarray(x))
    tc, tm = ivf_scan.quantize_queries(_t(x))
    assert tc.dtype == torch.int8 and tm.shape == (13, 4, 2)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)


def test_int8_cpu_dispatch_runs_plain_and_launches_nothing():
    ops.reset_launch_counts()
    args = [_t(a) for a in _int8_inputs(seed=4)]
    d, i = ops.ivf_block_topk_int8(*args, kprime=32)
    pd, pi = ref.ivf_block_topk_int8_ref(*args, kprime=32)
    assert torch.equal(i, pi) and torch.equal(d, pd)
    assert sum(ops.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        ivf_scan.ivf_block_topk_int8(*args, kprime=32)
