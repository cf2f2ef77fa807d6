"""The paper's comparison baselines (``repro_torch.core.baselines``) held
to the reference's classes (``repro.core.baselines``) on the CPU.

Both packages get the same centroids (the reference's ``kmeans`` is
replaced by them, the port's are passed to ``train``) and the same add
batches, several, so lists grow across adds.  Search ids must match
exactly, distances within rtol = atol = 1e-5, and ``ntotal`` exactly.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro_torch.core import baselines as tb

N_LISTS, DIM, N_ROWS, N_QUERIES = 16, 16, 2000, 16
RTOL = ATOL = 1e-5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    cents = (rng.normal(size=(N_LISTS, DIM)) * 3).astype(np.float32)
    pick = rng.integers(0, N_LISTS, N_ROWS + N_QUERIES)
    x = (cents[pick] + rng.normal(size=(len(pick), DIM))).astype(np.float32)
    return cents, x[:N_ROWS], x[N_ROWS:]


CASES = [
    (jb.FaissLikeIndex, tb.FaissLikeIndex, {}, {"device": "cpu"}),
    (jb.RaftLikeIndex, tb.RaftLikeIndex, {}, {"device": "cpu"}),
    # blocks of 32 rows: the lists' chains grow across the add batches
    (jb.RtCpuIndex, tb.RtCpuIndex, {"block_size": 32}, {"block_size": 32}),
]


@pytest.mark.parametrize("ref_cls,port_cls,ref_kw,port_kw", CASES,
                         ids=[c[1].__name__ for c in CASES])
def test_baseline_matches_reference(ref_cls, port_cls, ref_kw, port_kw):
    nprobe = 4
    cents, x, queries = _data()
    ref = ref_cls(N_LISTS, DIM, nprobe=nprobe, k=10, **ref_kw)
    port = port_cls(N_LISTS, DIM, nprobe=nprobe, k=10, **port_kw)
    with mock.patch.object(jb, "kmeans", lambda *a, **k: cents):
        ref.train(x)
    port.train(x, centroids=cents)
    bounds = (0, 500, 1200, N_ROWS)
    for a, b in zip(bounds, bounds[1:]):
        np.testing.assert_array_equal(port.add(x[a:b]), np.asarray(ref.add(x[a:b])))
        assert port.ntotal == ref.ntotal == b
    d_ref, i_ref = ref.search(queries)
    d_port, i_port = port.search(queries)
    np.testing.assert_array_equal(i_port, np.asarray(i_ref))
    np.testing.assert_allclose(d_port, np.asarray(d_ref), rtol=RTOL, atol=ATOL)
    assert (i_port >= 0).all()


def test_baseline_ids_given_by_the_caller():
    cents, x, queries = _data(1)
    ids = np.arange(10_000, 10_000 + N_ROWS, dtype=np.int32)
    ref = jb.RaftLikeIndex(N_LISTS, DIM, nprobe=4, k=5)
    port = tb.RaftLikeIndex(N_LISTS, DIM, nprobe=4, k=5, device="cpu")
    with mock.patch.object(jb, "kmeans", lambda *a, **k: cents):
        ref.train(x)
    port.train(x, centroids=cents)
    ref.add(x, ids)
    port.add(x, ids)
    d_ref, i_ref = ref.search(queries[:6])
    d_port, i_port = port.search(queries[:6])
    np.testing.assert_array_equal(i_port, np.asarray(i_ref))
    assert i_port.min() >= 10_000


def test_port_kmeans_trains_when_no_centroids_are_given():
    _, x, _ = _data(2)
    port = tb.FaissLikeIndex(N_LISTS, DIM, device="cpu", kmeans_iters=3)
    port.train(x)
    assert tuple(port.centroids.shape) == (N_LISTS, DIM)
    port.add(x[:500])
    assert port.ntotal == 500


@pytest.mark.parametrize("cls", [tb.FaissLikeIndex, tb.RaftLikeIndex])
def test_realloc_baselines_need_a_card_by_default(cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(N_LISTS, DIM)
