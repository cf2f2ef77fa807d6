"""The port's search path, IVFIndex and state transfer against the JAX
package, plus the port's import boundary.

End to end, both packages build the same index from the same corpus and the
same injected centroids (k-means may split near-ties differently in float),
and the port's ``union_fused`` search (its plain versions, on the CPU) is
held to the reference's ``union_fused_scan``: ids exact, distances within
rtol = atol = 1e-5 (both sides sum in float32 in different orders).
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core.ivf as jivf
import repro_torch.core.ivf as tivf
from repro.core import block_pool as jbp
from repro.core import insert as jins
from repro.core import search as jsearch
from repro.kernels.ivf_scan import coarse_topk_scan
from repro_torch.configs.anns import ivfflat_sift1m, ivfpq_dssm40m
from repro_torch.core import block_pool as tbp
from repro_torch.core import search as tsearch

ROOT = Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-5
N_LISTS, DIM = 16, 32


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(N_LISTS, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, N_LISTS, n)] + rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    x = _data(3000, DIM, seed=0)
    q = _data(13, DIM, seed=1)
    # the corpus's own mode centers, jittered: every list gets a share
    rng = np.random.default_rng(0)
    modes = rng.normal(size=(N_LISTS, DIM)).astype(np.float32) * 3
    cents = modes + 0.1 * np.random.default_rng(2).normal(size=modes.shape)
    return x, q, cents.astype(np.float32)


def _build_both(monkeypatch, corpus, **kw):
    """build_ivf in both packages from the same injected centroids."""
    x, _, cents = corpus
    monkeypatch.setattr(jivf, "kmeans", lambda *a, **k: cents.copy())
    monkeypatch.setattr(tivf, "kmeans", lambda *a, **k: cents.copy())
    common = dict(n_clusters=N_LISTS, block_size=16, max_chain=32,
                  add_batch=1024, nprobe=4, k=10, **kw)
    j = jivf.build_ivf(x, search_path="union_fused_scan", **common)
    t = tivf.build_ivf(x, search_path="union_fused", device="cpu", **common)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rerank", [False, True])
def test_ivf_index_end_to_end_matches_reference(monkeypatch, corpus, dtype, rerank):
    j, t = _build_both(monkeypatch, corpus, dtype=dtype, rerank=rerank)
    assert t.ntotal == j.ntotal == 3000
    assert t.stats() == j.stats()
    assert t._chain_budget() == j._chain_budget()
    q = corpus[1]
    jd, ji = j.search(q)
    td, ti = t.search(q)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    # online insert, then search again: new rows are visible at once
    new = _data(50, DIM, seed=7)
    np.testing.assert_array_equal(t.add(new), j.add(new))
    jd, ji = j.search(new[:13], k=1)
    td, ti = t.search(new[:13], k=1)
    np.testing.assert_array_equal(ti, ji)
    assert (ti[:, 0] == np.arange(3000, 3013)).all()


def test_state_round_trip_from_reference(corpus):
    """The reference's state_to_host, loaded by the port and searched by
    both, gives the same ids; the port writes back the same leaves."""
    x, q, cents = corpus
    for dtype in ("float32", "bfloat16", "int8"):
        cfg = jbp.PoolConfig(n_clusters=N_LISTS, dim=DIM, block_size=16,
                             n_blocks=300, max_chain=32, dtype=dtype)
        js = jbp.init_state(cfg, jnp.asarray(cents))
        js = jins.make_insert_fn(cfg)(js, jnp.asarray(x),
                                      jnp.arange(len(x), dtype=jnp.int32))
        arrays, meta = jivf.state_to_host(js)
        ts = tivf.state_from_host(arrays, meta, device="cpu")
        if dtype == "bfloat16":
            assert ts.pool_payload.dtype == torch.bfloat16
        back, back_meta = tivf.state_to_host(ts)
        assert back_meta == meta
        for name, arr in arrays.items():
            assert back[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(back[name], arr, err_msg=name)
        if dtype == "int8":  # int8 search arrives with a later slice
            continue
        tcfg = tbp.PoolConfig(n_clusters=N_LISTS, dim=DIM, block_size=16,
                              n_blocks=300, max_chain=32, dtype=dtype)
        jfn = jsearch.make_search_fn(cfg, nprobe=4, k=10, path="union_fused_scan")
        tfn = tsearch.make_search_fn(tcfg, nprobe=4, k=10, path="union_fused")
        jd, ji = jfn(js, jnp.asarray(q))
        td, ti = tfn(ts, torch.from_numpy(q))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)


def test_state_from_host_refuses_corrupt_or_foreign_state(corpus):
    x, _, cents = corpus
    cfg = jbp.PoolConfig(n_clusters=N_LISTS, dim=DIM, block_size=16,
                         n_blocks=300, max_chain=32)
    arrays, meta = jivf.state_to_host(jbp.init_state(cfg, jnp.asarray(cents)))
    bad = dict(arrays, pool_ids=arrays["pool_ids"].copy())
    bad["pool_ids"][0, 0] = 5
    with pytest.raises(tivf.StateChecksumError, match="pool_ids"):
        tivf.state_from_host(bad, meta, device="cpu")
    with pytest.raises(tivf.StateSchemaError):
        tivf.state_from_host(arrays, dict(meta, schema=2), device="cpu")
    missing = {k: v for k, v in arrays.items() if k != "cur_p"}
    with pytest.raises(tivf.StateSchemaError, match="cur_p"):
        tivf.state_from_host(missing, meta, device="cpu")


def test_union_candidates_match_reference(monkeypatch, corpus):
    j, t = _build_both(monkeypatch, corpus)
    q = corpus[1]
    juc = jsearch._union_candidates(j.pool_cfg, j.state, jnp.asarray(q), 4, 2, "scan")
    tuc = tsearch._union_candidates(t.pool_cfg, t.state, torch.from_numpy(q), 4, 2)
    jflat = np.asarray(juc.flat_blocks)
    n = int((jflat != -1).sum())
    np.testing.assert_array_equal(tuc.flat_blocks.numpy(), jflat[:n])
    np.testing.assert_array_equal(tuc.owners.numpy(), np.asarray(juc.owners)[:n])
    np.testing.assert_array_equal(tuc.probe_idx.numpy(), np.asarray(juc.probe_idx))


def test_dense_helpers_match_reference(monkeypatch, corpus):
    j, t = _build_both(monkeypatch, corpus)
    x, q, _ = corpus
    ji, jd = jsearch.coarse_probe(j.state, jnp.asarray(q), 5)
    ti, td = tsearch.coarse_probe(t.state, torch.from_numpy(q), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    si, _ = coarse_topk_scan(jnp.asarray(q), j.state.centroids, nprobe=5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(si))
    jd, ji = jsearch.exact_search(jnp.asarray(x), jnp.asarray(q), 10)
    td, ti = tsearch.exact_search(torch.from_numpy(x), torch.from_numpy(q), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=1e-4)
    assert tsearch.default_kprime(10) == jsearch.default_kprime(10) == 128
    assert tsearch.default_kprime(300) == jsearch.default_kprime(300)


def test_unported_paths_and_payloads_raise(monkeypatch, corpus):
    j, t = _build_both(monkeypatch, corpus)
    assert set(tsearch.SEARCH_IMPLS) == set(jsearch.SEARCH_IMPLS)
    for path in ("block_table", "chain_walk", "union", "union_pallas"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsearch.make_search_fn(t.pool_cfg, nprobe=4, k=10, path=path)
    with pytest.raises(ValueError, match="unknown search_path"):
        tsearch.make_search_fn(t.pool_cfg, nprobe=4, k=10, path="union_fuzed")
    int8 = tbp.PoolConfig(n_clusters=4, dim=8, block_size=4, n_blocks=8,
                          max_chain=2, dtype="int8")
    with pytest.raises(NotImplementedError, match="int8"):
        tsearch.make_search_fn(int8, nprobe=2, k=1, path="union_fused")
    with pytest.raises(NotImplementedError, match="PQ"):
        tivf.IVFIndex(ivfpq_dssm40m(0.001), device="cpu")
    for call in (lambda: t.delete([0]), lambda: t.update(corpus[0][:1], [0]),
                 t.maybe_rearrange):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    default = tivf.IVFIndex(dataclasses.replace(t.cfg, search_path="block_table"),
                            device="cpu")
    default.state = t.state
    with pytest.raises(NotImplementedError, match="block_table"):
        default.search(corpus[1])


def test_index_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tivf.IVFIndex(ivfflat_sift1m(0.01))
    assert tivf.IVFIndex(ivfflat_sift1m(0.01), device="cpu").device.type == "cpu"


def test_sift1m_config_matches_reference():
    from repro.configs.anns import ivfflat_sift1m as jcfg

    assert dataclasses.asdict(ivfflat_sift1m(1.0)) == dataclasses.asdict(jcfg(1.0))
    pool = ivfflat_sift1m(1.0).pool_config()
    assert pool.n_blocks == 3969 and pool.n_clusters == 4000


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
