"""The port's durability formats against the JAX package's, on the CPU
(marker: persist).

* ``encode_record`` and whole WAL segments are byte-equal to the
  reference's for the same records.
* Checkpoint tree structures spell jax's ``PyTreeDef`` string, with the
  leaves in jax's order; snapshot manifests of the two packages are equal
  apart from ``time``, and each package loads the other's snapshot.
* A persist directory written by either package's ``ServingRuntime``
  (inserts, a snapshot, deletes, updates, more inserts, then a crash:
  the runtime is abandoned) recovers in both, for float32, bfloat16,
  int8 and PQ payloads: the recovered states are equal leaf by leaf and
  the searched ids are equal (distances within rtol = atol = 1e-5).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.ivf as jivf
import repro.persist.snapshot as jsnap
import repro.persist.wal as jwal
import repro_torch.core.ivf as tivf
import repro_torch.persist.snapshot as tsnap
import repro_torch.persist.wal as twal
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.runtime import RuntimeConfig as JRuntimeConfig
from repro.core.runtime import ServingRuntime as JRuntime
from repro.persist.recovery import recover_index as j_recover
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.core.runtime import RuntimeConfig as TRuntimeConfig
from repro_torch.core.runtime import ServingRuntime as TRuntime
from repro_torch.persist.recovery import recover_index as t_recover

pytestmark = pytest.mark.persist

D = 8
RTOL = ATOL = 1e-5
WAIT = 60.0


def _data(n, d=D, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(77).normal(size=(4, d)) * 3
    return (centers[rng.integers(0, 4, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def _records():
    v = _data(5, seed=1)
    return [
        ("insert", np.arange(5, dtype=np.int32), v),
        ("delete", np.array([1, 3], np.int32), None),
        ("update", np.array([0, 4], np.int32), v[:2] * 2),
        ("delete", np.zeros(0, np.int32), None),
        ("insert", np.array([7], np.int32), v[:1] - 1),
    ]


# ------------------------------------------------------------------ WAL ---
def test_encode_record_and_segments_are_byte_equal(tmp_path):
    for lsn, (kind, ids, vec) in enumerate(_records(), start=1):
        assert twal.encode_record(lsn, kind, ids, vec) == \
            jwal.encode_record(lsn, kind, ids, vec), kind
    walls = {}
    for name, mod in (("ref", jwal), ("port", twal)):
        wal = mod.MutationWAL(str(tmp_path / name))
        for i, (kind, ids, vec) in enumerate(_records()):
            wal.append(kind, ids, vec)
            if i == 1:
                wal.rotate()
        wal.close()
        walls[name] = sorted(glob.glob(str(tmp_path / name / "wal_*.log")))
    assert [os.path.basename(p) for p in walls["ref"]] == \
        [os.path.basename(p) for p in walls["port"]]
    assert len(walls["ref"]) == 2
    for a, b in zip(walls["ref"], walls["port"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)
    # and each package reads the other's log
    for reader, name in ((twal, "ref"), (jwal, "port")):
        records, report = reader.read_wal(str(tmp_path / name))
        assert [r.lsn for r in records] == [1, 2, 3, 4, 5]
        assert report["torn_tail"] == 0


# ----------------------------------------------------------- checkpoints --
@pytest.mark.parametrize("tree", [
    {"pq": [], "state": [1, 2, 3]},
    [np.zeros(3)],
    [1, [2, 3]],
    {"b": 1, "a": {"d": [1], "c": 2}},
    {"x": None, "y": (4,)},
    (1, 2),
    {},
    5,
])
def test_tree_structure_spells_jax_treedef(tree):
    leaves, treedef = tree_flatten(tree)
    j_leaves, j_def = jax.tree.flatten(tree)
    assert treedef == str(j_def)
    assert len(leaves) == len(j_leaves)
    for a, b in zip(leaves, j_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _small_index(payload="flat", dtype="float32"):
    x = _data(600, seed=2)
    kw = dict(n_clusters=4, block_size=16, max_chain=32,
              capacity_vectors=4000, device="cpu", dtype=dtype,
              add_batch=256, kmeans_iters=4)
    if payload == "pq":
        kw.update(payload="pq", pq_m=4)
    return tivf.build_ivf(x, **kw)


def test_snapshot_manifests_equal_apart_from_time(tmp_path):
    idx = _small_index(payload="pq")
    arrays, meta = tivf.state_to_host(idx.state)
    books = idx.pq.codebooks.numpy()
    tsnap.publish(TManager(str(tmp_path / "port")), arrays, meta, lsn=7,
                  next_id=600, pq_books=books)
    jsnap.publish(JManager(str(tmp_path / "ref")), arrays, meta, lsn=7,
                  next_id=600, pq_books=books)
    mans = {}
    for name in ("port", "ref"):
        with open(tmp_path / name / "step_0000000007" / "manifest.json") as f:
            mans[name] = json.load(f)
    assert mans["port"].pop("time") > 0 and mans["ref"].pop("time") > 0
    assert mans["port"] == mans["ref"]
    assert mans["port"]["treedef"].startswith("PyTreeDef({'pq': [*], ")
    # each package loads the other's snapshot, CRC-verified
    t_state, t_pq, _ = tsnap.load_latest(str(tmp_path / "ref"), device="cpu")
    j_state, j_pq, _ = jsnap.load_latest(str(tmp_path / "port"))
    t_back, _ = tivf.state_to_host(t_state)
    j_back, _ = jivf.state_to_host(j_state)
    for name in arrays:
        np.testing.assert_array_equal(t_back[name], arrays[name], name)
        np.testing.assert_array_equal(j_back[name], arrays[name], name)
    np.testing.assert_array_equal(t_pq.codebooks.numpy(), books)
    np.testing.assert_array_equal(np.asarray(j_pq.codebooks), books)


# ------------------------------------------------------ persist dirs -------
PAYLOADS = {
    "float32": dict(dtype="float32"),
    "bfloat16": dict(dtype="bfloat16"),
    "int8": dict(dtype="int8"),
    "pq": dict(payload="pq", pq_m=4),
}


def _cfg_kw(payload):
    return dict(n_clusters=4, dim=D, block_size=16, max_chain=32,
                capacity_vectors=4000, kmeans_iters=4, nprobe=4, k=5,
                **PAYLOADS[payload])


def _write(writer, payload, root):
    """One run of acked traffic through ``writer``'s runtime, with a
    snapshot between, then a crash (the runtime is abandoned)."""
    train = _data(512, seed=3)
    if writer == "ref":
        idx = jivf.IVFIndex(jivf.IVFIndexConfig(**_cfg_kw(payload)))
        rcfg = JRuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=64,
                              flush_interval=0.02, persist_dir=str(root),
                              search_path="union_fused_scan")
        make = JRuntime
    else:
        idx = tivf.IVFIndex(tivf.IVFIndexConfig(**_cfg_kw(payload)),
                            device="cpu")
        rcfg = TRuntimeConfig(mode="parallel", nprobe=4, k=5, flush_min=64,
                              flush_interval=0.02, persist_dir=str(root),
                              search_path="union_fused")
        make = TRuntime
    idx.train(train)
    idx.add(train[:200])
    rt = make(idx, rcfg)
    ids = list(rt.submit_insert(_data(8, seed=4)).result(WAIT))
    ids += list(rt.submit_insert(_data(8, seed=5)).result(WAIT))
    rt.snapshot(wait=True)
    rt.submit_delete(np.array(ids[:4] + [3, 5, 7, 9], np.int32)).result(WAIT)
    rt.submit_update(_data(8, seed=6),
                     np.array(ids[8:12] + [11, 13, 15, 17], np.int32)
                     ).result(WAIT)
    rt.submit_insert(_data(8, seed=7)).result(WAIT)
    s = rt.stats()
    assert s["applied_lsn"] == s["wal_lsn"] == 5 and s["snapshot_lsn"] == 2


@pytest.mark.parametrize("payload", sorted(PAYLOADS))
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_persist_dir_recovers_in_both_packages(tmp_path, writer, payload):
    _write(writer, payload, tmp_path)
    t_idx, t_rep = t_recover(
        tivf.IVFIndexConfig(search_path="union_fused", **_cfg_kw(payload)),
        str(tmp_path), device="cpu")
    j_idx, j_rep = j_recover(
        jivf.IVFIndexConfig(search_path="union_fused_scan",
                            **_cfg_kw(payload)),
        str(tmp_path))
    assert t_rep.verified and j_rep.verified
    assert t_rep.as_dict() == j_rep.as_dict()
    assert t_rep.snapshot_lsn == 2 and t_rep.replayed_records == 3
    t_arrays, t_meta = tivf.state_to_host(t_idx.state)
    j_arrays, j_meta = jivf.state_to_host(j_idx.state)
    assert t_meta == j_meta  # schema, dtypes, shapes and every leaf's CRC
    for name in t_arrays:
        np.testing.assert_array_equal(t_arrays[name], j_arrays[name], name)
    assert t_idx._next_id == j_idx._next_id
    if payload == "pq":
        np.testing.assert_array_equal(t_idx.pq.codebooks.numpy(),
                                      np.asarray(j_idx.pq.codebooks))
    q = _data(9, seed=8)
    td, ti = t_idx.search(q)
    jd, ji = j_idx.search(jnp.asarray(q))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=RTOL, atol=ATOL)
    assert torch.is_tensor(t_idx.state.pool_ids)
