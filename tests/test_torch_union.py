"""The port's ``union`` and ``union_pallas`` comparison search paths against
the JAX package's ``search_union``.

Both packages hold the same pool state, made by one scripted sequence of
inserts and deletes (``test_torch_mutation.Both``), and search it with the
same queries: ids exact, distances within rtol = atol = 1e-5 (both sides
sum in float32 in different orders).  The reference's ``union`` runs its
dense coarse probe and ``ivf_block_scan_ref``; its ``union_pallas`` runs
its Pallas kernels in interpret mode on the CPU, as its own tests do.  On
the CPU the port's ``union_pallas`` takes the kernels' plain versions
(``kernels/ops.py``); ``test_torch_kernels_cuda.py`` holds the CUDA kernel
to them on the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core.ivf as jivf
import repro_torch.core.ivf as tivf
from repro.core import search as jsearch
from repro.kernels import ref as jref
from repro_torch.core import search as tsearch
from repro_torch.kernels import ops, ref as tref
from test_torch_mutation import Both, _around

RTOL = ATOL = 1e-5
PATHS = ["union", "union_pallas"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivf_block_scan_ref_matches_reference(dtype):
    rng = np.random.default_rng(0)
    q, p, t, d = 7, 9, 16, 24
    queries = rng.normal(size=(q, d)).astype(np.float32)
    pool = rng.normal(size=(p, t, d)).astype(np.float32)
    bids = np.array([3, -1, 0, 8, 5, -1, 2], np.int32)  # holes read block 0
    jpool = jnp.asarray(pool).astype(getattr(jnp, dtype))
    tpool = torch.from_numpy(pool).to(getattr(torch, dtype))
    want = np.asarray(jref.ivf_block_scan_ref(jnp.asarray(queries), jpool,
                                              jnp.asarray(bids)))
    got = tref.ivf_block_scan_ref(torch.from_numpy(queries), tpool,
                                  torch.from_numpy(bids))
    assert got.shape == (len(bids), q, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # on the CPU the dispatcher takes the plain version
    assert torch.equal(ops.ivf_block_scan(torch.from_numpy(queries), tpool,
                                          torch.from_numpy(bids)), got)


def _state(dtype, deletes: bool):
    """A pool of 8 lists over 640 rows (chains of up to 4 blocks), with
    the oldest quarter of the ids deleted if ``deletes``."""
    b = Both(dtype)
    x = _around(b.modes, 640, seed=4)
    b.insert(x, np.arange(640, dtype=np.int32))
    if deletes:
        dead = np.arange(0, 640, 4, dtype=np.int32)
        b.delete(dead)
    return b


def _search_both(b, path, queries, **kw):
    jfn = jsearch.make_search_fn(b.jc, path=path, **kw)
    tfn = tsearch.make_search_fn(b.tc, path=path, **kw)
    jd, ji = jfn(b.js, jnp.asarray(queries))
    td, ti = tfn(b.ts, torch.from_numpy(queries))
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("deletes", [False, True])
def test_union_paths_match_reference(path, dtype, deletes):
    b = _state(dtype, deletes)
    queries = _around(b.modes, 9, seed=5)
    for budget in (None, 2):  # the whole chains, then their first 2 blocks
        (jd, ji), (td, ti) = _search_both(b, path, queries, nprobe=3, k=10,
                                          chain_budget=budget)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
        assert (ti >= 0).all()
        if deletes:  # tombstoned ids never come back
            assert not np.isin(ti, np.arange(0, 640, 4)).any()


@pytest.mark.parametrize("path", PATHS)
def test_union_paths_pad_k_above_the_live_rows(path):
    """k above every live row of the probed lists: the (inf, -1) tail the
    reference's static candidate width gives, as far as k asks; a k above
    that width is refused by both."""
    b = Both("float32", n_blocks=24, max_chain=2)
    x = _around(b.modes, 40, seed=6)
    b.insert(x, np.arange(40, dtype=np.int32))
    b.delete(np.arange(0, 40, 3, dtype=np.int32))
    queries = _around(b.modes, 2, seed=7)
    # 2 queries x 1 probe x 2 chain slots: a width of 4 blocks of 16 rows,
    # of which the port's candidate list holds fewer than k = 60 rows
    uc = tsearch._union_candidates(b.tc, b.ts, torch.from_numpy(queries), 1, None)
    assert uc.flat_blocks.numel() * 16 < 60
    (jd, ji), (td, ti) = _search_both(b, path, queries, nprobe=1, k=60)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    assert np.isinf(td[:, -1]).all() and (ti[:, -1] == -1).all()
    assert ((ti == -1) == np.isinf(td)).all()
    for lib, cfg, state, q in ((tsearch, b.tc, b.ts, torch.from_numpy(queries)),
                               (jsearch, b.jc, b.js, jnp.asarray(queries))):
        with pytest.raises((ValueError, TypeError)):
            lib.make_search_fn(cfg, path=path, nprobe=1, k=65)(state, q)


@pytest.mark.parametrize("path", PATHS)
def test_ivf_index_routes_through_the_union_paths(monkeypatch, path):
    """``IVFIndex(search_path=...)`` end to end on both packages (same
    corpus, same injected centroids), and the route really is the union
    path: its scan, not the fused one, scores the batch."""
    rng = np.random.default_rng(8)
    modes = rng.normal(size=(8, 16)).astype(np.float32) * 3
    x = _around(modes, 600, seed=9)
    monkeypatch.setattr(jivf, "kmeans", lambda *a, **k: modes.copy())
    monkeypatch.setattr(tivf, "kmeans", lambda *a, **k: modes.copy())
    common = dict(n_clusters=8, block_size=16, max_chain=16, add_batch=256,
                  nprobe=3, k=5, search_path=path)
    j = jivf.build_ivf(x, **common)
    t = tivf.build_ivf(x, device="cpu", **common)
    calls = []
    real = tref.ivf_block_scan_ref
    monkeypatch.setattr(tref, "ivf_block_scan_ref",
                        lambda *a: calls.append(1) or real(*a))
    q = _around(modes, 6, seed=10)
    jd, ji = j.search(q)
    td, ti = t.search(q)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    assert calls == [1]
    # the new rows are visible at once
    new = _around(modes, 4, seed=11)
    np.testing.assert_array_equal(t.add(new), j.add(new))
    np.testing.assert_array_equal(t.search(new, k=1)[1][:, 0], np.arange(600, 604))
    t.cfg.rerank = True
    with pytest.raises(NotImplementedError, match="rerank"):
        t.search(q)
