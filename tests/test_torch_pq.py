"""The port's IVFPQ payload against the JAX package.

Stated tolerance, the port's parity contract: ids exact, distances within
rtol = atol = 1e-5.  The port adds the M table entries of an ADC sum in the
order j = 0..M-1 (the order of the ADC kernels); the reference's oracles
sum with ``jnp.sum``, which may add in another order.  Codes must be equal.

* The PQ primitives (``encode``, ``decode``, ``adc_lut``,
  ``probe_residual_luts``, ``adc_accumulate``) on the same codebooks.
* The kernels' plain versions, ``ivf_pq_block_topk_ref`` and
  ``pq_adc_ref``, against the reference's oracles on the reference's own
  input maker (holes, empty slots, non-members), with exact code ties.
* ``IVFIndex`` end to end, both packages on the same injected centroids and
  codebooks: every state leaf after the build and after online inserts,
  and search on ``union_fused`` (rerank off and on), ``block_table`` and
  ``chain_walk`` (``use_kernel`` off and on); ``block_table`` and
  ``chain_walk`` on a flat float32 index too.
* Delete, update and compaction on a PQ pool: every leaf after each step.
* Carry-over: a PQ index built and trained by the JAX package, loaded
  through ``state_from_host`` and ``pq_from_host``, searched by the port.

The reference runs through its ``scan``/``jnp`` routes only, never Pallas
interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core.ivf as jivf
import repro_torch.core.ivf as tivf
from repro.core import insert as jins
from repro.core import mutate as jmut
from repro.core import pq as jpq
from repro.core import search as jsearch
from repro.kernels import ref as jref
from repro.kernels.ivf_scan import ivf_pq_block_topk_scan
from repro_torch.core import block_pool as tbp
from repro_torch.core import insert as tins
from repro_torch.core import mutate as tmut
from repro_torch.core import pq as tpq
from repro_torch.core import search as tsearch
from repro_torch.kernels import ivf_scan, ops, pq_adc, ref
from test_pq_fused import _pq_topk_inputs
from test_torch_insert import _assert_states_equal
from test_torch_kernels_cuda import _adc_inputs
from test_torch_mutation import Both, _around

RTOL = ATOL = 1e-5
N_LISTS, DIM, M, T = 16, 32, 8, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _codebooks(residuals, m, seed):
    """[M, 256, dsub] codebooks drawn from the residuals' own subvectors, so
    both packages share them without training."""
    rng = np.random.default_rng(seed)
    dsub = residuals.shape[1] // m
    books = np.stack([
        residuals[rng.choice(len(residuals), 256, replace=False),
                  j * dsub:(j + 1) * dsub]
        for j in range(m)
    ])
    return books.astype(np.float32)


# ----------------------------------------------------- PQ primitives ----


def test_pq_primitives_match_reference():
    rng = np.random.default_rng(0)
    books = rng.normal(size=(M, 256, DIM // M)).astype(np.float32)
    res = rng.normal(size=(500, DIM)).astype(np.float32)
    jp, tp = jpq.PQParams(codebooks=jnp.asarray(books)), tpq.pq_from_host(books, "cpu")
    assert (tp.m, tp.dsub, tp.dim) == (jp.m, jp.dsub, jp.dim)
    jc = np.asarray(jpq.encode(jp, jnp.asarray(res)))
    tc = tpq.encode(tp, _t(res))
    assert tc.dtype == torch.uint8
    # no near-tie between the two nearest codewords of any subvector: the
    # smallest gap (printed on failure) is above the float32 rounding of
    # these distances (below 50, so a few ulps are under 2e-5)
    sub = res.reshape(-1, M, DIM // M)
    d2 = ((sub[:, :, None, :] - books[None]) ** 2).sum(-1)
    assert d2.min(-1).max() < 50
    two = np.sort(d2, axis=-1)[..., :2]
    assert (two[..., 1] - two[..., 0]).min() > 2e-5, (two[..., 1] - two[..., 0]).min()
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tpq.decode(tp, tc).numpy(),
                                  np.asarray(jpq.decode(jp, jnp.asarray(jc))))
    qres = rng.normal(size=(5, 3, DIM)).astype(np.float32)
    _close(tpq.adc_lut(tp, _t(qres)), jpq.adc_lut(jp, jnp.asarray(qres)))
    cents = rng.normal(size=(N_LISTS, DIM)).astype(np.float32)
    q = rng.normal(size=(5, DIM)).astype(np.float32)
    probe = np.stack([rng.permutation(N_LISTS)[:4] for _ in range(5)]).astype(np.int32)
    tl = tpq.probe_residual_luts(tp, _t(cents), _t(q), _t(probe))
    jl = jpq.probe_residual_luts(jp, jnp.asarray(cents), jnp.asarray(q),
                                 jnp.asarray(probe))
    _close(tl, jl)
    codes = rng.integers(0, 256, size=(5, 4, 40, M)).astype(np.uint8)
    _close(tpq.adc_accumulate(tl, _t(codes)),
           jpq.adc_accumulate(jl, jnp.asarray(codes)))


def test_pq_encode_hook_and_train_shapes():
    rng = np.random.default_rng(1)
    res = rng.normal(size=(600, 16)).astype(np.float32)
    pq = tpq.train_pq(res, 4, n_iter=2, device="cpu")
    assert tuple(pq.codebooks.shape) == (4, 256, 4)
    with pytest.raises(ValueError, match="divisible"):
        tpq.train_pq(res, 5, device="cpu")
    with pytest.raises(ValueError, match="codebooks"):
        tpq.pq_from_host(np.zeros((4, 16, 4), np.float32), "cpu")


# ------------------------------------ plain kernel versions vs the JAX ----


def _with_ties(inputs):
    lut, codes, *rest = (np.array(a) for a in inputs)
    codes[:] = codes[0].copy()  # every block holds the same codes
    codes[:, 1::2] = codes[:, 0:1]  # and rows tie inside a block
    return (lut, codes, *rest)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("q,npb,m,p,t,c,kp", [
    (8, 4, 8, 6, 16, 5, 8),
    (10, 3, 4, 5, 8, 7, 16),
    (4, 2, 8, 4, 32, 3, 128),  # kprime > live candidates
    (1, 4, 2, 6, 8, 6, 4),
])
def test_ivf_pq_block_topk_ref_matches_jax(q, npb, m, p, t, c, kp, ties):
    inputs = _pq_topk_inputs(q, npb, m, p, t, c, seed=q * 10 + c)
    if ties:
        inputs = _with_ties(inputs)
    td, ti = ref.ivf_pq_block_topk_ref(*map(_t, inputs), kprime=kp)
    j_in = [jnp.asarray(a) for a in inputs]
    for jd, ji in (
        jref.ivf_pq_block_topk_ref(*j_in, kprime=kp),
        ivf_pq_block_topk_scan(*j_in, kprime=kp, chunk=4),
    ):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(td, jd)
    if ties:  # equal distances come back in location order (a block
        # listed twice gives the same location twice)
        d, i = td.numpy(), ti.numpy()
        same = (d[:, 1:] == d[:, :-1]) & np.isfinite(d[:, 1:])
        assert (i[:, 1:][same] >= i[:, :-1][same]).all()
        assert kp < 8 or (same & (i[:, 1:] != i[:, :-1])).any()


@pytest.mark.parametrize("ties", [False, True])
def test_pq_adc_ref_matches_jax(ties):
    lut, codes = _adc_inputs(seed=5, r=6, n=300, m=8, ties=ties)
    got = ref.pq_adc_ref(_t(lut), _t(codes))
    _close(got, jref.pq_adc_ref(jnp.asarray(lut), jnp.asarray(codes)))
    # the batched form adc_accumulate uses is the same sum
    np.testing.assert_array_equal(
        ref.pq_adc_ref(_t(lut)[:, None], _t(codes)[:, None]).numpy()[:, 0],
        got.numpy())


def test_pq_cpu_dispatch_runs_plain_and_launches_nothing():
    ops.reset_launch_counts()
    inputs = [_t(a) for a in _pq_topk_inputs(8, 4, 8, 6, 16, 5, seed=1)]
    d, i = ops.ivf_pq_block_topk(*inputs, kprime=16)
    want = ref.ivf_pq_block_topk_ref(*inputs, kprime=16)
    assert torch.equal(d, want[0]) and torch.equal(i, want[1])
    lut, codes = map(_t, _adc_inputs(seed=2))
    assert torch.equal(ops.pq_adc(lut, codes), ref.pq_adc_ref(lut, codes))
    assert sum(ops.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc.pq_adc(lut, codes)
    with pytest.raises(ValueError, match="CUDA"):
        ivf_scan.ivf_pq_block_topk(*inputs, kprime=16)


# ------------------------------------------------ IVFIndex end to end ----


def _data(n, seed):
    rng = np.random.default_rng(seed)
    modes = np.random.default_rng(0).normal(size=(N_LISTS, DIM)).astype(np.float32) * 3
    x = modes[rng.integers(0, N_LISTS, n)] + rng.normal(size=(n, DIM))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def pq_pair():
    """Both packages' IVFPQ index, built by ``build_ivf`` from the same
    injected centroids and codebooks, then grown by online inserts."""
    x = _data(3000, seed=1)
    modes = np.random.default_rng(0).normal(size=(N_LISTS, DIM)).astype(np.float32) * 3
    cents = (modes + 0.1 * np.random.default_rng(2).normal(size=modes.shape)).astype(np.float32)
    assign = ((x[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
    books = _codebooks(x - cents[assign], M, seed=3)
    mp = pytest.MonkeyPatch()
    mp.setattr(jivf, "kmeans", lambda *a, **k: cents.copy())
    mp.setattr(tivf, "kmeans", lambda *a, **k: cents.copy())
    mp.setattr(jpq, "train_pq", lambda *a, **k: jpq.PQParams(jnp.asarray(books)))
    mp.setattr(tpq, "train_pq", lambda *a, **k: tpq.pq_from_host(books, "cpu"))
    try:
        common = dict(n_clusters=N_LISTS, payload="pq", pq_m=M, block_size=T,
                      max_chain=32, add_batch=1024, nprobe=4, k=10)
        j = jivf.build_ivf(x, **common)
        t = tivf.build_ivf(x, device="cpu", **common)
    finally:
        mp.undo()
    _assert_states_equal(j.state, t.state)
    np.testing.assert_array_equal(t.pq.codebooks.numpy(), np.asarray(j.pq.codebooks))
    new = _data(70, seed=7)
    np.testing.assert_array_equal(t.add(new), j.add(new))
    _assert_states_equal(j.state, t.state)
    assert t.stats() == j.stats() and t.ntotal == 3070
    tbp.check_invariants(t.state, t.pool_cfg)
    return j, t


def _j_search(j, path, q, *, rerank=False, k=10, nprobe=4):
    fn = jsearch.make_search_fn(
        j.pool_cfg, nprobe=nprobe, k=k, path=path, score_fn=jpq.pq_score_fn(j.pq),
        chain_budget=j._chain_budget(), pq=j.pq, rerank=rerank,
    )
    return fn(j.state, jnp.asarray(q))


def _t_search(t, path, q, *, rerank=False, use_kernel=False, k=10, nprobe=4):
    t.cfg.search_path, t.cfg.rerank, t.cfg.use_kernel = path, rerank, use_kernel
    try:
        return t.search(q, nprobe=nprobe, k=k)
    finally:
        t.cfg.search_path, t.cfg.rerank, t.cfg.use_kernel = "block_table", False, False


def _same(t_out, j_out):
    (td, ti), (jd, ji) = t_out, j_out
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
    _close(td, jd)


@pytest.mark.parametrize("rerank", [False, True])
def test_ivfpq_union_fused_matches_reference(pq_pair, rerank):
    j, t = pq_pair
    q = _data(13, seed=9)
    _same(_t_search(t, "union_fused", q, rerank=rerank),
          _j_search(j, "union_fused_scan", q, rerank=rerank))
    # the plain path of the port gives the same
    _same(_t_search(t, "union_fused_scan", q, rerank=rerank),
          _j_search(j, "union_fused_scan", q, rerank=rerank))


@pytest.mark.parametrize("path", ["block_table", "chain_walk"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ivfpq_gather_paths_match_reference(pq_pair, path, use_kernel):
    j, t = pq_pair
    q = _data(13, seed=9)
    got = _t_search(t, path, q, use_kernel=use_kernel)
    _same(got, _j_search(j, path, q))
    # union_fused agrees with block_table (the reference's
    # test_ivfpq_union_fused_matches_block_table): the same top-k
    fd, fi = _t_search(t, "union_fused", q)
    _same((fd, fi), got)


def test_ivfpq_k_exceeds_live_and_every_id_is_real(pq_pair):
    """One probed list of about 190 rows and k = 250 (as the reference's
    test_ivfpq_union_fused_k_exceeds_live): an (inf, -1) tail.  k above
    block_table's gathered slots (one chain of 16 blocks of 16) raises in
    both packages."""
    j, t = pq_pair
    q = _data(5, seed=10)
    assert t._chain_budget() * T == 256
    for path in ("union_fused", "block_table", "chain_walk"):
        d, i = _t_search(t, path, q, k=250, nprobe=1)
        jpath = path if path != "union_fused" else "union_fused_scan"
        _same((d, i), _j_search(j, jpath, q, k=250, nprobe=1))
        assert np.isinf(d).any() and (i[np.isinf(d)] == -1).all()
        assert np.isin(i[i >= 0], np.arange(t.ntotal)).all()
    with pytest.raises(ValueError, match="k"):
        _j_search(j, "block_table", q, k=300, nprobe=1)
    with pytest.raises(ValueError, match="k 300"):
        _t_search(t, "block_table", q, k=300, nprobe=1)


@pytest.mark.parametrize("path", ["block_table", "chain_walk"])
def test_flat_gather_paths_match_reference(monkeypatch, path):
    x = _data(3000, seed=1)
    cents = np.random.default_rng(0).normal(size=(N_LISTS, DIM)).astype(np.float32) * 3
    monkeypatch.setattr(jivf, "kmeans", lambda *a, **k: cents.copy())
    monkeypatch.setattr(tivf, "kmeans", lambda *a, **k: cents.copy())
    common = dict(n_clusters=N_LISTS, block_size=T, max_chain=32, add_batch=1024,
                  nprobe=4, k=10, search_path=path)
    j = jivf.build_ivf(x, **common)
    t = tivf.build_ivf(x, device="cpu", **common)
    q = _data(13, seed=9)
    jd, ji = j.search(q)
    td, ti = t.search(q)
    np.testing.assert_array_equal(ti, ji)
    _close(td, jd)
    # the same neighbours as union_fused on the same index
    t.cfg.search_path = "union_fused"
    _, fi = t.search(q)
    np.testing.assert_array_equal(fi, ti)
    assert (t.search(x[:13], k=1)[1][:, 0] == np.arange(13)).all()


# -------------------------------------- mutations on a PQ pool, by leaf ----


class BothPQ(Both):
    """``Both`` over a PQ pool: inserts and updates encode through each
    package's PQ hook, on the same codebooks."""

    def __init__(self, **kw):
        super().__init__("float32", payload="pq", pq_m=4, **kw)
        x = _around(self.modes, 2000, seed=1)
        res = x - self.modes[((x[:, None] - self.modes[None]) ** 2).sum(-1).argmin(1)]
        books = _codebooks(res, 4, seed=4)
        je = jpq.make_pq_encode_fn(jpq.PQParams(jnp.asarray(books)))
        te = tpq.make_pq_encode_fn(tpq.pq_from_host(books, "cpu"))
        self.j_ins = jins.make_insert_fn(self.jc, encode=je)
        self.t_ins = tins.make_insert_fn(self.tc, encode=te)
        self.j_upd = jmut.make_update_fn(self.jc, encode=je)
        self.t_upd = tmut.make_update_fn(self.tc, encode=te)


def test_pq_mutation_state_parity():
    b = BothPQ()
    assert b.tc.payload_shape() == (72, 16, 4)
    rng = np.random.default_rng(0)
    nid = 0
    for i, n in enumerate((300, 250, 150)):
        b.insert(_around(b.modes, n, seed=10 + i), np.arange(nid, nid + n, dtype=np.int32))
        nid += n
    snap = tbp.snapshot_ids(b.ts, b.tc)
    full = max(snap, key=lambda c: len(snap[c]))
    victims = rng.choice(np.setdiff1d(np.arange(nid), snap[full]), 200, replace=False)
    ids = np.concatenate([snap[full], victims, victims[:7], [800, 1023, -1]]).astype(np.int32)
    b.delete(ids)
    routes = b.compact(threshold=10**9, dead_frac=0.3)
    assert "empty" in routes, routes
    live = np.asarray(sorted(i for v in tbp.snapshot_ids(b.ts, b.tc).values() for i in v))
    targets = rng.choice(live, 40, replace=False)
    ids = np.concatenate([targets, targets[:5], [900, 901]]).astype(np.int32)
    b.update(_around(b.modes, len(ids), seed=20), ids)
    routes += b.compact(threshold=40, dead_frac=0.3)
    assert "bump" in routes and "free" in routes, routes
    b.insert(_around(b.modes, 90, seed=30), np.arange(nid, nid + 90, dtype=np.int32))
    assert int(b.ts.num_dropped) == int(b.js.num_dropped)


def test_churned_pq_index_search_matches_reference(pq_pair):
    """IVFIndex.delete / update / maybe_rearrange on both packages' PQ
    indexes (copies of the module's pair), then every leaf and the search
    of every PQ path."""
    j0, t0 = pq_pair
    j = jivf.IVFIndex(dataclasses.replace(j0.cfg, rearrange_threshold=10**9,
                                          dead_frac_threshold=0.15))
    t = tivf.IVFIndex(dataclasses.replace(t0.cfg, rearrange_threshold=10**9,
                                          dead_frac_threshold=0.15), device="cpu")
    j.install_state(j0.state, pq=j0.pq, next_id=j0._next_id)
    t.state = tivf.state_from_host(*tivf.state_to_host(t0.state), device="cpu")
    t.pq, t._next_id = t0.pq, t0._next_id
    t._build_fns()
    rng = np.random.default_rng(7)
    dead = rng.choice(3070, 900, replace=False).astype(np.int32)
    assert t.delete(dead) == j.delete(dead) == 900
    upd = rng.choice(np.setdiff1d(np.arange(3070), dead), 60, replace=False).astype(np.int32)
    newv = _data(60, seed=8)
    t.update(newv, upd)
    j.update(newv, upd)
    _assert_states_equal(j.state, t.state)
    passes = t.maybe_rearrange(max_passes=64)
    assert passes == j.maybe_rearrange(max_passes=64) and 0 < passes < 64
    _assert_states_equal(j.state, t.state)
    tbp.check_invariants(t.state, t.pool_cfg)
    q = _data(13, seed=11)
    for path, jpath in (("union_fused", "union_fused_scan"),
                        ("block_table", "block_table"), ("chain_walk", "chain_walk")):
        d, i = _t_search(t, path, q)
        _same((d, i), _j_search(j, jpath, q))
        assert not np.isin(i[i >= 0], dead).any()
    _same(_t_search(t, "union_fused", q, rerank=True),
          _j_search(j, "union_fused_scan", q, rerank=True))
    # every updated id is found for its own new vector
    _, own = _t_search(t, "union_fused", newv[:13], rerank=True)
    assert all(u in row for u, row in zip(upd[:13], own))


# ------------------------------------------------------------ carry-over ----


def test_jax_built_pq_index_carries_over():
    """A PQ index built and trained (k-means, PQ codebooks) by the JAX
    package, then loaded into the port: the port's make_search_fn gives
    the JAX index's results."""
    rng = np.random.default_rng(12)
    modes = rng.normal(size=(8, 16)).astype(np.float32) * 3
    x = (modes[rng.integers(0, 8, 1500)] + rng.normal(size=(1500, 16))).astype(np.float32)
    j = jivf.build_ivf(x, n_clusters=8, payload="pq", pq_m=4, block_size=16,
                       max_chain=32, add_batch=512, nprobe=3, k=10, kmeans_iters=4)
    arrays, meta = jivf.state_to_host(j.state)
    ts = tivf.state_from_host(arrays, meta, device="cpu")
    pq = tpq.pq_from_host(np.asarray(j.pq.codebooks), "cpu")
    tcfg = tivf.IVFIndexConfig(**{f.name: getattr(j.cfg, f.name)
                                  for f in dataclasses.fields(j.cfg)}).pool_config()
    q = (modes[rng.integers(0, 8, 9)] + rng.normal(size=(9, 16))).astype(np.float32)
    budget = j._chain_budget()
    for path, jpath, use_kernel in (("union_fused", "union_fused_scan", False),
                                    ("block_table", "block_table", True),
                                    ("chain_walk", "chain_walk", False)):
        jfn = jsearch.make_search_fn(j.pool_cfg, nprobe=3, k=10, path=jpath,
                                     score_fn=jpq.pq_score_fn(j.pq),
                                     chain_budget=budget, pq=j.pq)
        tfn = tsearch.make_search_fn(tcfg, nprobe=3, k=10, path=path,
                                     score_fn=tpq.pq_score_fn(pq, use_kernel=use_kernel),
                                     chain_budget=budget, pq=pq)
        _same(tfn(ts, _t(q)), jfn(j.state, jnp.asarray(q)))
