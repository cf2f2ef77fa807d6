"""The port's mutation lane (delete, update, Alg. 3 compaction) against the
JAX package.

The same scripted sequence goes through both packages' step functions
(``make_insert_fn``, ``make_delete_fn``, ``make_update_fn``,
``make_rearrange_fn``) and every leaf of the state must be equal after
each step, payload and ``pool_scales`` included, for float32, bfloat16 and
int8.  End to end, ``IVFIndex.delete``/``update``/``maybe_rearrange`` churn
both packages' indexes (same injected centroids) and the port's
``union_fused`` search is held to the reference's ``union_fused_scan``:
ids exact, distances within rtol = atol = 1e-5 (both sides sum in float32
in different orders).  A seeded random interleaving holds the port to a
host-side dict.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core.ivf as jivf
import repro_torch.core.ivf as tivf
from repro.core import block_pool as jbp
from repro.core import insert as jins
from repro.core import mutate as jmut
from repro.core import rearrange as jrea
from repro.core import search as jsearch
from repro_torch.core import block_pool as tbp
from repro_torch.core import insert as tins
from repro_torch.core import mutate as tmut
from repro_torch.core import rearrange as trea
from repro_torch.core import search as tsearch
from test_torch_insert import _assert_states_equal

RTOL = ATOL = 1e-5
DTYPES = ["float32", "bfloat16", "int8"]


def _modes(n_modes, d, seed):
    return np.random.default_rng(seed).normal(size=(n_modes, d)).astype(np.float32) * 3


def _around(modes, n, seed):
    rng = np.random.default_rng(seed)
    x = modes[rng.integers(0, len(modes), n)] + rng.normal(size=(n, modes.shape[1]))
    return x.astype(np.float32)


class Both:
    """One scripted sequence applied to both packages' states."""

    def __init__(self, dtype, **kw):
        kw = dict(dict(n_clusters=8, dim=16, block_size=16, n_blocks=72,
                       max_chain=16, max_ids=1024, dtype=dtype), **kw)
        self.jc, self.tc = jbp.PoolConfig(**kw), tbp.PoolConfig(**kw)
        self.modes = _modes(kw["n_clusters"], kw["dim"], seed=3)
        self.js = jbp.init_state(self.jc, jnp.asarray(self.modes))
        self.ts = tbp.init_state(self.tc, torch.from_numpy(self.modes), "cpu")
        self.j_ins, self.t_ins = jins.make_insert_fn(self.jc), tins.make_insert_fn(self.tc)
        self.j_del, self.t_del = jmut.make_delete_fn(self.jc), tmut.make_delete_fn(self.tc)
        self.j_upd, self.t_upd = jmut.make_update_fn(self.jc), tmut.make_update_fn(self.tc)

    def check(self):
        _assert_states_equal(self.js, self.ts)
        tbp.check_invariants(self.ts, self.tc)

    def insert(self, x, ids):
        self.js = self.j_ins(self.js, jnp.asarray(x), jnp.asarray(ids))
        self.ts = self.t_ins(self.ts, torch.from_numpy(x), torch.from_numpy(ids))
        self.check()

    def delete(self, ids, valid=None):
        jv = None if valid is None else jnp.asarray(valid)
        tv = None if valid is None else torch.from_numpy(valid)
        self.js = self.j_del(self.js, jnp.asarray(ids), jv)
        self.ts = self.t_del(self.ts, torch.from_numpy(ids), tv)
        self.check()

    def update(self, x, ids):
        self.js = self.j_upd(self.js, jnp.asarray(x), jnp.asarray(ids))
        self.ts = self.t_upd(self.ts, torch.from_numpy(x), torch.from_numpy(ids))
        self.check()

    def compact(self, threshold, dead_frac, max_passes=64):
        """Passes until quiescent; returns the route of every pass that
        moved rows: "bump" (cur_p grew) or "free" (a free-stack run)."""
        jr = jrea.make_rearrange_fn(self.jc, threshold, dead_frac)
        tr = trea.make_rearrange_fn(self.tc, threshold, dead_frac)
        routes = []
        for _ in range(max_passes):
            cur_p, table = int(self.ts.cur_p), self.ts.cluster_blocks.clone()
            self.js, jt = jr(self.js)
            self.ts, tt = tr(self.ts)
            assert bool(jt) == tt
            self.check()
            if not tt:
                return routes
            k = int((self.ts.cluster_blocks != table).any(1).long().argmax())
            if int(self.ts.cur_p) > cur_p:
                routes.append("bump")
            elif int(self.ts.cluster_nblocks[k]):
                routes.append("free")
            else:
                routes.append("empty")
        raise AssertionError("compaction did not quiesce")


@pytest.mark.parametrize("dtype", DTYPES)
def test_scripted_mutation_state_parity(dtype):
    b = Both(dtype)
    rng = np.random.default_rng(0)
    nid = 0
    for i, n in enumerate((300, 250, 150)):
        b.insert(_around(b.modes, n, seed=10 + i), np.arange(nid, nid + n, dtype=np.int32))
        nid += n
    # a fully-dead chain: every id of the largest cluster
    snap = tbp.snapshot_ids(b.ts, b.tc)
    assert snap == jbp.snapshot_ids(b.js, b.jc)
    full = max(snap, key=lambda c: len(snap[c]))
    victims = rng.choice(np.setdiff1d(np.arange(nid), snap[full]), 220, replace=False)
    ids = np.concatenate([
        snap[full], victims,
        victims[:12],  # duplicates: the first occurrence wins
        [800, 801, 1023],  # never inserted
        [1024, 5000],  # past max_ids
        [-1, -7],  # negative padding
    ]).astype(np.int32)
    valid = rng.random(len(ids)) > 0.1  # some real targets masked out
    valid[: len(snap[full])] = True
    before = int(b.ts.num_deleted)
    b.delete(ids, valid)
    assert int(b.ts.num_deleted) - before == len(set(ids[valid & (ids >= 0) & (ids < nid)]))
    assert int(b.ts.dead_count[full]) == len(snap[full])
    # the dead-fraction trigger: the fully-dead chain frees every block
    routes = b.compact(threshold=10**9, dead_frac=0.3)
    assert "empty" in routes, routes
    assert int(b.ts.cluster_nblocks[full]) == 0 and int(b.ts.cluster_head[full]) == -1
    assert int(b.ts.dead_count.sum()) == 0
    # updates: duplicate targets (the last write wins) and upsert misses
    live = np.asarray(sorted(i for v in tbp.snapshot_ids(b.ts, b.tc).values() for i in v))
    targets = rng.choice(live, 40, replace=False)
    ids = np.concatenate([targets, targets[:5], [900, 901], snap[full][:1]]).astype(np.int32)
    b.update(_around(b.modes, len(ids), seed=20), ids)
    assert int(b.ts.num_missed) == int(b.js.num_missed)
    # then Exceed() at a small threshold; 72 blocks run out of bump room
    # after a few runs, so the rest come off the free stack
    routes += b.compact(threshold=40, dead_frac=0.3)
    assert "bump" in routes and "free" in routes, routes
    assert int(b.ts.new_since_rearrange.max()) <= 40
    # growth after compaction lands in recycled blocks
    b.insert(_around(b.modes, 90, seed=30), np.arange(nid, nid + 90, dtype=np.int32))
    assert int(b.ts.num_dropped) == int(b.js.num_dropped)


def test_compaction_keeps_reclaiming_after_the_bump_region_is_exhausted():
    """Churn until cur_p nears the pool end, then keep churning: the
    free-stack route must go on giving the space back (the reference's
    ``test_compaction_survives_bump_exhaustion``, at this file's sizes)."""
    b = Both("int8", n_clusters=8, n_blocks=40, max_chain=8)
    rng = np.random.default_rng(11)
    nid = 0
    for round_ in range(6):
        b.insert(_around(b.modes, 64, seed=100 + round_), np.arange(nid, nid + 64, dtype=np.int32))
        nid += 64
        assert int(b.ts.num_dropped) == 0, round_
        live = [i for v in tbp.snapshot_ids(b.ts, b.tc).values() for i in v]
        victims = np.full(64, -1, np.int32)  # one batch shape: one compile
        victims[: len(live) // 2] = rng.choice(live, len(live) // 2, replace=False)
        b.delete(victims, victims >= 0)
        b.compact(threshold=10**9, dead_frac=0.2)
        assert int(b.ts.dead_count.sum()) == 0, round_
    assert int(b.ts.cur_p) >= b.tc.n_blocks - b.tc.max_chain


def test_mutation_helpers_match_reference():
    rng = np.random.default_rng(4)
    ids = rng.integers(-2, 6, 40).astype(np.int32)
    valid = rng.random(40) > 0.3
    np.testing.assert_array_equal(
        tmut.last_occurrence_mask(torch.from_numpy(ids), torch.from_numpy(valid)).numpy(),
        np.asarray(jmut.last_occurrence_mask(jnp.asarray(ids), jnp.asarray(valid))),
    )
    assert tmut.REPLAY_KINDS == jmut.REPLAY_KINDS
    b = Both("float32")
    b.insert(_around(b.modes, 200, seed=1), np.arange(200, dtype=np.int32))
    np.testing.assert_array_equal(trea.exceed(b.ts, 20).numpy(),
                                  np.asarray(jrea.exceed(b.js, 20)))
    fns = tmut.make_replay_fns(b.tc)
    assert set(fns) == set(tmut.REPLAY_KINDS)
    x = _around(b.modes, 8, seed=2)
    ids = np.arange(195, 203, dtype=np.int32)
    b.ts = fns["update"](b.ts, torch.from_numpy(x), torch.from_numpy(ids))
    b.js = jmut.make_replay_fns(b.jc)["update"](b.js, jnp.asarray(x), jnp.asarray(ids))
    b.ts = fns["delete"](b.ts, None, torch.from_numpy(ids[:3]))
    b.js = jmut.make_replay_fns(b.jc)["delete"](b.js, None, jnp.asarray(ids[:3]))
    b.check()


# ------------------------------------------------ IVFIndex end to end ----

N_LISTS, DIM = 16, 32
_churned_cache = {}


def _index_pair(dtype):
    """Both packages' IVFIndex on the same injected centroids, churned by
    the same delete/update/compaction calls (cached per dtype)."""
    if dtype in _churned_cache:
        return _churned_cache[dtype]
    modes = _modes(N_LISTS, DIM, seed=0)
    cents = modes + 0.1 * np.random.default_rng(2).normal(size=modes.shape).astype(np.float32)
    x = _around(modes, 3000, seed=1)
    kw = dict(n_clusters=N_LISTS, dim=DIM, block_size=16, max_chain=32,
              capacity_vectors=6000, nprobe=4, k=10, dtype=dtype,
              rearrange_threshold=10**9, dead_frac_threshold=0.15)
    j = jivf.IVFIndex(jivf.IVFIndexConfig(search_path="union_fused_scan", **kw))
    t = tivf.IVFIndex(tivf.IVFIndexConfig(search_path="union_fused", **kw), device="cpu")
    j.state = jbp.init_state(j.pool_cfg, jnp.asarray(cents))
    j._build_fns()
    t.state = tbp.init_state(t.pool_cfg, torch.from_numpy(cents), "cpu")
    t._build_fns()
    for off in range(0, len(x), 1024):
        np.testing.assert_array_equal(t.add(x[off:off + 1024]), j.add(x[off:off + 1024]))
    rng = np.random.default_rng(7)
    dead = rng.choice(3000, 900, replace=False).astype(np.int32)
    n_t, n_j = t.delete(dead), j.delete(dead)
    assert n_t == n_j == 900
    assert t.delete(dead[:10]) == j.delete(dead[:10]) == 0  # already deleted
    upd = rng.choice(np.setdiff1d(np.arange(3000), dead), 60, replace=False).astype(np.int32)
    newv = _around(modes, 60, seed=8)
    t.update(newv, upd)
    j.update(newv, upd)
    passes = t.maybe_rearrange(max_passes=64)
    assert passes == j.maybe_rearrange(max_passes=64) and 0 < passes < 64
    _assert_states_equal(j.state, t.state)
    tbp.check_invariants(t.state, t.pool_cfg)
    _churned_cache[dtype] = (j, t, set(dead.tolist()), upd, newv)
    return _churned_cache[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rerank", [False, True])
def test_churned_index_search_matches_reference(dtype, rerank):
    j, t, dead, upd, newv = _index_pair(dtype)
    assert t.stats() == j.stats()
    # fresh queries from the seed: perturbed rows would sit in near-ties
    q = _around(_modes(N_LISTS, DIM, seed=0), 13, seed=9)
    budget = t._chain_budget()
    assert budget == j._chain_budget()
    jfn = jsearch.make_search_fn(j.pool_cfg, nprobe=4, k=10, path="union_fused_scan",
                                 chain_budget=budget, rerank=rerank)
    jd, ji = jfn(j.state, jnp.asarray(q))
    t.cfg.rerank = rerank
    td, ti = t.search(q)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=RTOL, atol=ATOL)
    found = ti[ti >= 0]
    assert found.size and not np.isin(found, sorted(dead)).any()
    live = np.asarray(sorted(i for v in tbp.snapshot_ids(t.state, t.pool_cfg).values()
                             for i in v))
    assert np.isin(found, live).all()
    # every updated id is found for its own new vector
    _, own = t.search(newv[:13], k=10)
    assert all(u in row for u, row in zip(upd[:13], own))


# ----------------------------------------- random interleaving vs a dict ----


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_random_interleaving_against_a_host_dict(dtype):
    cfg = tbp.PoolConfig(n_clusters=8, dim=16, block_size=16, n_blocks=60,
                         max_chain=12, max_ids=4096, dtype=dtype)
    modes = _modes(8, 16, seed=5)
    state = tbp.init_state(cfg, torch.from_numpy(modes), "cpu")
    ins, dele = tins.make_insert_fn(cfg), tmut.make_delete_fn(cfg)
    upd = tmut.make_update_fn(cfg)
    rea = trea.make_rearrange_fn(cfg, threshold=60, dead_frac=0.25)
    search = tsearch.make_search_fn(cfg, nprobe=8, k=10, path="union_fused")
    rng = np.random.default_rng(42)
    oracle, deleted, nid, n_updated = {}, set(), 0, 0
    for step in range(48):
        op = rng.choice(["insert", "delete", "update", "compact", "search"],
                        p=[0.3, 0.25, 0.2, 0.1, 0.15])
        if op == "insert":
            n = int(rng.integers(1, 40))
            x = _around(modes, n, seed=1000 + step)
            state = ins(state, torch.from_numpy(x), torch.arange(nid, nid + n, dtype=torch.int32))
            oracle.update({nid + i: x[i] for i in range(n)})
            nid += n
        elif op == "delete" and oracle:
            ids = rng.choice(sorted(oracle), min(len(oracle), int(rng.integers(1, 30))),
                             replace=False)
            ids = np.concatenate([ids, ids[:2], [nid + 5]]).astype(np.int32)
            state = dele(state, torch.from_numpy(ids))
            for i in ids:
                if oracle.pop(int(i), None) is not None:
                    deleted.add(int(i))
        elif op == "update" and oracle:
            ids = rng.choice(sorted(oracle), min(len(oracle), int(rng.integers(1, 20))),
                             replace=False).astype(np.int32)
            x = _around(modes, len(ids), seed=2000 + step)
            state = upd(state, torch.from_numpy(x), torch.from_numpy(ids))
            oracle.update({int(i): v for i, v in zip(ids, x)})
            n_updated += len(ids)  # each update tombstones the old row
        elif op == "compact":
            for _ in range(32):
                state, triggered = rea(state)
                if not triggered:
                    break
        elif op == "search" and oracle:
            _, ids = search(state, torch.from_numpy(_around(modes, 7, seed=3000 + step)))
            found = set(ids[ids >= 0].tolist())
            assert not found & deleted, step
            assert found <= set(oracle), step
        assert int(state.num_dropped) == 0, step
        tbp.check_invariants(state, cfg)
        live = sorted(i for v in tbp.snapshot_ids(state, cfg).values() for i in v)
        assert live == sorted(oracle), (step, op)
    assert deleted and int(state.num_deleted) == len(deleted) + n_updated
