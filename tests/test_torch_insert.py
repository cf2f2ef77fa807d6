"""The port's pool state, insert path and k-means against the JAX package.

Every integer leaf of the state is held exactly equal to the reference's
after several insert batches (the stable per-cluster rank, chain- and
pool-capacity rejection, block table, owners, linked list, heads/tails,
id map, counters); payload rows are equal too, for float32, bfloat16 and
int8 (with ``pool_scales``).  Centroids from k-means agree within
rtol = atol = 1e-5: both sides sum in float32 in different orders.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import block_pool as jbp
from repro.core import insert as jins
from repro.core.kmeans import kmeans as jkmeans
from repro.data import synthetic as jsyn
from repro_torch.core import block_pool as tbp
from repro_torch.core import insert as tins
from repro_torch.core.kmeans import kmeans as tkmeans
from repro_torch.data import synthetic as tsyn


def _data(n, d, seed, modes=12, spread=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(modes, d)).astype(np.float32) * spread
    x = centers[rng.integers(0, modes, n)] + rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


def _leaf(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _assert_states_equal(js, ts):
    for f in dataclasses.fields(jbp.IVFState):
        a, b = _leaf(getattr(js, f.name)), _leaf(getattr(ts, f.name))
        assert a.shape == b.shape, (f.name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def _run_both(dtype, batches, **pool_kw):
    """The same insert batches through both packages' make_insert_fn."""
    kw = dict(n_clusters=8, dim=16, block_size=16, n_blocks=200, max_chain=16,
              dtype=dtype)
    kw.update(pool_kw)
    jc, tc = jbp.PoolConfig(**kw), tbp.PoolConfig(**kw)
    cents = _data(kw["n_clusters"], kw["dim"], seed=5)
    js = jbp.init_state(jc, jnp.asarray(cents))
    ts = tbp.init_state(tc, torch.from_numpy(cents), "cpu")
    jf, tf = jins.make_insert_fn(jc), tins.make_insert_fn(tc)
    nxt = 0
    for i, (bsz, valid) in enumerate(batches):
        x = _data(bsz, kw["dim"], seed=10 + i)
        ids = np.arange(nxt, nxt + bsz, dtype=np.int32)
        nxt += bsz
        jv = None if valid is None else jnp.asarray(valid)
        tv = None if valid is None else torch.from_numpy(valid)
        js = jf(js, jnp.asarray(x), jnp.asarray(ids), jv)
        ts = tf(ts, torch.from_numpy(x), torch.from_numpy(ids), tv)
    return jc, tc, js, ts


def test_synthetic_corpora_same_bytes():
    for fn in ("sift_like", "dssm_like"):
        a = getattr(jsyn, fn)(500, seed=3)
        b = getattr(tsyn, fn)(500, seed=3)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_quantize_int8_matches_jitted_reference():
    import jax

    x = _data(4000, 16, seed=2)
    jc, js = jax.jit(jbp.quantize_int8)(jnp.asarray(x))
    tc, ts = tbp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    back = tbp.dequantize_int8(tc, ts).numpy()
    np.testing.assert_allclose(back, x, atol=float(ts.max()))


def test_assign_clusters_matches_reference():
    cents = _data(16, 32, seed=1)
    x = _data(3000, 32, seed=2)
    ja = jins.assign_clusters(jnp.asarray(cents), jnp.asarray(x))
    ta = tins.assign_clusters(torch.from_numpy(cents), torch.from_numpy(x))
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_insert_state_parity(dtype):
    rng = np.random.default_rng(0)
    ragged = rng.random(40) < 0.7  # padding rows masked out of every scatter
    batches = [(300, None), (17, None), (40, ragged), (450, None), (999, None)]
    jc, tc, js, ts = _run_both(dtype, batches, n_blocks=400, max_chain=64)
    _assert_states_equal(js, ts)
    tbp.check_invariants(ts, tc)
    assert int(ts.num_dropped) == 0
    assert tbp.snapshot_ids(ts, tc) == jbp.snapshot_ids(js, jc)
    assert tbp.pool_stats(ts, tc) == jbp.pool_stats(js, jc)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_insert_parity_when_the_pool_runs_out(dtype):
    batches = [(120, None), (200, None), (333, None)]
    jc, tc, js, ts = _run_both(dtype, batches, n_blocks=20, max_chain=16)
    _assert_states_equal(js, ts)
    tbp.check_invariants(ts, tc)
    assert int(ts.num_dropped) > 0
    assert int(ts.cur_p) == tc.n_blocks
    assert not tbp.capacity_ok(ts, tc)


def test_insert_parity_when_chains_hit_max_chain():
    batches = [(200, None), (300, None)]
    jc, tc, js, ts = _run_both("float32", batches, n_blocks=500, max_chain=2,
                               n_clusters=4)
    _assert_states_equal(js, ts)
    tbp.check_invariants(ts, tc)
    assert int(ts.num_dropped) > 0
    assert int(ts.cluster_nblocks.max()) == 2


def test_insert_counts_unmappable_ids():
    jc, tc, js, ts = _run_both("float32", [(100, None)], max_ids=50)
    _assert_states_equal(js, ts)
    assert int(ts.num_unmapped) == 50


def test_alloc_helpers_match_reference():
    jc, tc, js, ts = _run_both("float32", [(300, None)])
    j = np.arange(-1, 12, dtype=np.int32)
    valid = j % 3 != 0
    ja = jbp.alloc_blocks(js, jnp.asarray(j), jnp.asarray(valid))
    ta = tbp.alloc_blocks(ts, torch.from_numpy(j).long(), torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    assert int(jbp.alloc_available(js)) == int(tbp.alloc_available(ts))
    assert tbp.utilisation(ts, tc) == pytest.approx(float(jbp.utilisation(js, jc)))
    assert tbp.dead_fraction(ts) == float(jbp.dead_fraction(js))


def test_kmeans_matches_reference_on_separated_data():
    x = _data(3000, 16, seed=4, modes=10, spread=20.0)
    jc = jkmeans(x, 10, n_iter=8, seed=3)
    tc = tkmeans(x, 10, n_iter=8, seed=3, device="cpu")
    assert tc.dtype == np.float32 and tc.shape == (10, 16)
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)


def test_kmeans_reseeds_empty_clusters_like_reference():
    # 6 distinct points, 6 clusters, init draws duplicates -> empty clusters
    base = _data(6, 8, seed=9, spread=10.0)
    x = np.repeat(base, [50, 1, 1, 1, 1, 1], axis=0)
    jc = jkmeans(x, 6, n_iter=4, seed=0)
    tc = tkmeans(x, 6, n_iter=4, seed=0, device="cpu")
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)
