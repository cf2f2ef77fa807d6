"""Durability in the port: twins of ``tests/test_persist.py`` on CPU indexes
(marker: persist).

The invariant under test everywhere: after a ``kill -9`` at *any* point —
mid-append, mid-fsync, mid-snapshot-publish, mid-replay, or between any
two of those — recovery either restores a state that contains exactly the
acknowledged mutations (verified against a host-side oracle) or refuses
to serve with a named error.  Crashes are simulated as the reference's
tests do: the runtime object is abandoned without ``stop()``, plus
byte-level truncation/flips for torn-write and bit-rot cases, plus
``FaultPlan`` rules at the four persist sites.

Where the reference's step is one jitted call after the append, the
port's step appends its own record first, under ``_write_lock`` (its
``_Record``); the twins that fake a failure after the append log the run
the way a real step does.  Then the port's own cases: the lock order
(the append under the single-writer hold, before the step's front; a
compaction pass and a snapshot cut both wait out a logged record) and the
host copy that never aliases a CPU index's live state.
"""

import glob
import json
import os
import shutil
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import (
    CheckpointCorruption,
    CheckpointManager,
)
from repro_torch.core.block_pool import NULL
from repro_torch.core.faults import KNOWN_SITES, FaultError, FaultPlan
from repro_torch.core.ivf import IVFIndex, IVFIndexConfig, host_copy
from repro_torch.core.runtime import (
    RuntimeConfig,
    ServingRuntime,
    _Step,
    _Timed,
)
from repro_torch.persist import (
    SNAP_SUBDIR,
    WAL_SUBDIR,
    MutationWAL,
    PersistDirConflict,
    RecoveryError,
    WALCorruption,
    WALUnavailable,
    read_wal,
    recover_index,
)

pytestmark = pytest.mark.persist

D = 8
WAIT = 30.0  # seconds any bounded wait may take before the test fails


def _data(n, d=D, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def _index_cfg(**kw):
    base = dict(
        n_clusters=4, dim=D, block_size=16, max_chain=64,
        capacity_vectors=4000, seed=0,
    )
    base.update(kw)
    return IVFIndexConfig(**base)


def _fresh_index(cfg):
    idx = IVFIndex(cfg, device="cpu")
    idx.train(_data(256, cfg.dim, seed=99))
    return idx


def _runtime(persist_dir, icfg=None, faults=None, **rkw):
    icfg = icfg or _index_cfg()
    base = dict(
        mode="parallel", nprobe=4, k=5, flush_min=64, flush_interval=0.05,
        persist_dir=str(persist_dir),
    )
    base.update(rkw)
    return ServingRuntime(
        _fresh_index(icfg), RuntimeConfig(**base), faults=faults
    ), icfg


def _recover(icfg, root, **kw):
    return recover_index(icfg, str(root), device="cpu", **kw)


def _live_vectors(index) -> dict:
    """Host oracle view of an index: id -> stored vector (flat payload)."""
    st, cfg = index.state, index.pool_cfg
    id_map = st.id_map.numpy()
    live = st.pool_live.numpy()
    pay = st.pool_payload.numpy()
    out = {}
    for vid in np.flatnonzero(id_map != NULL):
        loc = int(id_map[vid])
        blk, off = divmod(loc, cfg.block_size)
        if live[blk, off]:
            out[int(vid)] = pay[blk, off].copy()
    return out


def _assert_state_equals_oracle(index, oracle: dict):
    got = _live_vectors(index)
    assert sorted(got) == sorted(oracle), (
        f"live ids diverge: extra={sorted(set(got) - set(oracle))[:5]} "
        f"missing={sorted(set(oracle) - set(got))[:5]}"
    )
    for vid, vec in oracle.items():
        np.testing.assert_array_equal(got[vid], vec, err_msg=f"id {vid}")


# ------------------------------------------------------------- WAL unit ---
def test_wal_roundtrip(tmp_path):
    wal = MutationWAL(str(tmp_path))
    v = _data(5)
    l1 = wal.append("insert", np.arange(5, dtype=np.int32), v)
    l2 = wal.append("delete", np.array([1, 3], np.int32))
    l3 = wal.append("update", np.array([0], np.int32), v[:1] * 2)
    assert (l1, l2, l3) == (1, 2, 3)
    assert wal.durable_lsn == 3  # sync_interval=1: every append fsyncs
    wal.close()
    records, report = read_wal(str(tmp_path))
    assert [r.lsn for r in records] == [1, 2, 3]
    assert [r.kind for r in records] == ["insert", "delete", "update"]
    np.testing.assert_array_equal(records[0].vectors, v)
    np.testing.assert_array_equal(records[1].ids, [1, 3])
    assert records[1].vectors is None
    np.testing.assert_array_equal(records[2].vectors, v[:1] * 2)
    assert report["torn_tail"] == 0
    # min_lsn filters strictly-greater
    tail, _ = read_wal(str(tmp_path), min_lsn=2)
    assert [r.lsn for r in tail] == [3]


def test_wal_torn_tail_truncates_loudly_and_reopen_repairs(tmp_path):
    wal = MutationWAL(str(tmp_path))
    for i in range(3):
        wal.append("insert", np.array([i], np.int32), _data(1, seed=i))
    wal.close()
    (seg,) = glob.glob(str(tmp_path / "wal_*.log"))
    size = os.path.getsize(seg)
    with open(seg, "r+b") as f:
        f.truncate(size - 7)  # tear the last record mid-body
    records, report = read_wal(str(tmp_path))
    assert [r.lsn for r in records] == [1, 2]
    assert report["torn_tail"] == 1 and "torn" in report["torn_detail"]
    # reopening repairs the tail and continues numbering after the last
    # *intact* record — the torn lsn 3 is reissued
    wal2 = MutationWAL(str(tmp_path))
    assert wal2.append("delete", np.array([0], np.int32)) == 3
    wal2.close()
    records, report = read_wal(str(tmp_path))
    assert [(r.lsn, r.kind) for r in records] == [
        (1, "insert"), (2, "insert"), (3, "delete")
    ]
    assert report["torn_tail"] == 0  # the damage was healed on reopen


def test_wal_crc_flip_truncates_from_damage_point(tmp_path):
    wal = MutationWAL(str(tmp_path))
    for i in range(3):
        wal.append("insert", np.array([i], np.int32), _data(1, seed=i))
    wal.close()
    (seg,) = glob.glob(str(tmp_path / "wal_*.log"))
    with open(seg, "r+b") as f:
        f.seek(os.path.getsize(seg) // 2)  # lands inside record 2
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    records, report = read_wal(str(tmp_path))
    assert [r.lsn for r in records] == [1]  # 2 fails CRC; 3 is unreachable
    assert report["torn_tail"] == 1 and "CRC" in report["torn_detail"]


def test_wal_damage_in_non_final_segment_is_corruption(tmp_path):
    wal = MutationWAL(str(tmp_path))
    wal.append("insert", np.array([0], np.int32), _data(1))
    wal.rotate()
    wal.append("insert", np.array([1], np.int32), _data(1))
    wal.close()
    first = sorted(glob.glob(str(tmp_path / "wal_*.log")))[0]
    with open(first, "r+b") as f:
        f.truncate(os.path.getsize(first) - 3)
    with pytest.raises(WALCorruption, match="non-final"):
        read_wal(str(tmp_path))


def test_wal_missing_middle_segment_is_an_lsn_gap(tmp_path):
    wal = MutationWAL(str(tmp_path))
    for i in range(3):
        wal.append("insert", np.array([i], np.int32), _data(1))
        wal.rotate()  # one record per sealed segment
    wal.close()
    os.remove(sorted(glob.glob(str(tmp_path / "wal_*.log")))[1])
    with pytest.raises(WALCorruption, match="gap"):
        read_wal(str(tmp_path))


def test_wal_fsync_batching_and_prune(tmp_path):
    wal = MutationWAL(str(tmp_path), sync_interval=3)
    for i in range(2):
        wal.append("delete", np.array([i], np.int32))
    assert wal.last_lsn == 2 and wal.durable_lsn == 0  # batched, not due
    assert wal.sync() == 2
    wal.append("delete", np.array([9], np.int32))
    wal.rotate()  # rotate fsyncs + seals
    assert wal.durable_lsn == 3
    wal.append("delete", np.array([10], np.int32))
    assert wal.prune(upto_lsn=3) == 1  # the sealed segment is covered
    wal.close()
    records, _ = read_wal(str(tmp_path), min_lsn=3)
    assert [r.lsn for r in records] == [4]


def test_wal_lsn_floor_survives_full_prune(tmp_path):
    wal = MutationWAL(str(tmp_path))
    for i in range(4):
        wal.append("delete", np.array([i], np.int32))
    wal.rotate()
    wal.prune(4)  # everything covered by a (hypothetical) snapshot @ 4
    wal.close()
    # reopening with the fence as the floor must not reuse LSNs 1..4
    wal2 = MutationWAL(str(tmp_path), start_lsn=4)
    assert wal2.append("delete", np.array([9], np.int32)) == 5
    wal2.close()


def test_wal_failed_fsync_rolls_back_the_record(tmp_path):
    """A record whose due fsync fails must not leave its bytes in the
    segment: the retry's re-append would otherwise coexist with the dead
    record (duplicate rows / mid-log garbage on recovery)."""
    plan = FaultPlan().fail("wal_fsync", nth=1)
    wal = MutationWAL(str(tmp_path), faults=plan)
    assert wal.append("insert", np.array([0], np.int32), _data(1)) == 1
    size_before = os.path.getsize(wal._path)
    with pytest.raises(FaultError):
        wal.append("insert", np.array([1], np.int32), _data(1, seed=1))
    assert wal.last_lsn == 1  # lsn counter rolled back with the bytes
    assert os.path.getsize(wal._path) == size_before
    # a retry re-appends cleanly at the next lsn
    assert wal.append("insert", np.array([1], np.int32),
                      _data(1, seed=1)) == 2
    wal.close()
    records, report = read_wal(str(tmp_path))
    assert [r.lsn for r in records] == [1, 2]
    assert report["torn_tail"] == 0  # nothing of the failure lingers


def test_wal_fails_closed_when_rollback_fails(tmp_path):
    """If the post-failure truncate itself fails, the active tail is
    untrusted: further appends/rotates must raise WALUnavailable instead
    of burying garbage mid-log."""

    class _NoTruncate:
        def __init__(self, f):
            self._f = f

        def __getattr__(self, name):
            return getattr(self._f, name)

        def truncate(self, *a):
            raise OSError("injected truncate failure")

    plan = FaultPlan().fail("wal_fsync", nth=0)
    wal = MutationWAL(str(tmp_path), faults=plan)
    wal._file = _NoTruncate(wal._file)
    with pytest.raises(FaultError):
        wal.append("insert", np.array([0], np.int32), _data(1))
    with pytest.raises(WALUnavailable):
        wal.append("insert", np.array([1], np.int32), _data(1))
    with pytest.raises(WALUnavailable):
        wal.rotate()
    wal.close()


# ------------------------------------------------------ fault-site registry --
def test_fault_sites_are_registered():
    for site in ("wal_append", "wal_fsync", "snapshot_publish",
                 "recovery_replay"):
        assert site in KNOWN_SITES
    FaultPlan().fail("wal_append").delay("snapshot_publish", 0.01)  # ok


def test_unknown_fault_site_rejected_at_rule_creation():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan().fail("wal_appendz")
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan().delay("snapshot_pubish", 0.1)
    # escape hatch for test-private sites
    plan = FaultPlan(extra_sites=("my_harness_site",))
    plan.fail("my_harness_site", nth=0)
    with pytest.raises(FaultError):
        plan.check("my_harness_site")


# --------------------------------------------------- checkpoint manager ----
def _save(mgr, step, leaves, extra=None):
    mgr.save(step, [torch.as_tensor(x) for x in leaves], extra=extra)


def test_checkpoint_resave_has_no_unpublished_window(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    _save(mgr, 5, [np.arange(4)], extra={"v": 1})
    _save(mgr, 5, [np.arange(4) * 2], extra={"v": 2})  # re-save same step
    tree, man = mgr.restore(step=5, like=[np.zeros(4)], device="cpu")
    assert man["v"] == 2
    np.testing.assert_array_equal(tree[0].numpy(), np.arange(4) * 2)
    assert not glob.glob(str(tmp_path / "*.old"))
    assert not glob.glob(str(tmp_path / "*.tmp"))


def test_checkpoint_old_dir_with_missing_base_is_restored(tmp_path):
    """A crash between the two publish renames leaves ``step_X.old`` as the
    only good copy; the sweep restores it instead of deleting it."""
    mgr = CheckpointManager(str(tmp_path))
    _save(mgr, 7, [np.arange(3)], extra={"v": 1})
    d = mgr._step_dir(7)
    os.rename(d, d + ".old")  # simulate death between rename-aside/publish
    mgr2 = CheckpointManager(str(tmp_path))  # sweep runs at init
    assert mgr2.latest_step() == 7
    _, man = mgr2.restore(step=7, like=[np.zeros(3)], device="cpu")
    assert man["v"] == 1


def test_checkpoint_orphans_are_swept(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    _save(mgr, 3, [np.arange(3)])
    os.makedirs(str(tmp_path / "step_0000000009.tmp"))  # crashed save
    os.makedirs(str(tmp_path / "step_0000000003.old"))  # superseded leftover
    CheckpointManager(str(tmp_path))
    assert sorted(os.listdir(str(tmp_path))) == ["step_0000000003"]
    assert mgr.latest_step() == 3


def test_checkpoint_restore_raises_named_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    _save(mgr, 1, [np.arange(3), np.arange(5)])
    # leaf-count mismatch vs the `like` template: named, not a bare assert
    with pytest.raises(CheckpointCorruption, match="schema mismatch"):
        mgr.restore(step=1, like=[np.zeros(3)], device="cpu")
    # manifest/archive divergence
    man_path = os.path.join(mgr._step_dir(1), "manifest.json")
    with open(man_path) as f:
        manifest = json.load(f)
    manifest["n_leaves"] = 3
    with open(man_path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointCorruption, match="manifest says 3"):
        mgr.restore(step=1, like=[np.zeros(3), np.zeros(5)], device="cpu")
    # a shardings tree that does not match the template: named, not a bare error
    _save(mgr, 2, [np.arange(3), np.arange(5)])
    with pytest.raises(CheckpointCorruption, match="shardings tree"):
        mgr.restore(step=2, like=[np.zeros(3), np.zeros(5)], shardings=[None])


# ----------------------------------------------------- end-to-end recovery --
def _drive(rt, rng, oracle, n_ops=6, base_seed=0):
    """Random acked traffic; folds every *acked* result into the oracle."""
    for op in range(n_ops):
        kind = rng.choice(["insert", "insert", "delete", "update"])
        if kind == "insert" or not oracle:
            vecs = _data(int(rng.integers(1, 9)), seed=base_seed + op)
            ids = rt.submit_insert(vecs).result(WAIT)
            for i, vid in enumerate(ids):
                oracle[int(vid)] = vecs[i]
        elif kind == "delete":
            pick = rng.choice(sorted(oracle), size=min(3, len(oracle)),
                              replace=False).astype(np.int32)
            rt.submit_delete(pick).result(WAIT)
            for vid in pick:
                oracle.pop(int(vid), None)
        else:
            pick = rng.choice(sorted(oracle), size=min(2, len(oracle)),
                              replace=False).astype(np.int32)
            vecs = _data(len(pick), seed=1000 + base_seed + op)
            rt.submit_update(vecs, pick).result(WAIT)
            for i, vid in enumerate(pick):
                oracle[int(vid)] = vecs[i]


@pytest.mark.parametrize("mode", ["parallel", "fused"])
def test_recover_matches_acked_oracle(tmp_path, mode):
    rt, icfg = _runtime(tmp_path, mode=mode)
    rng = np.random.default_rng(7)
    oracle: dict = {}
    _drive(rt, rng, oracle, n_ops=5)
    rt.snapshot(wait=True)  # barrier mid-history
    _drive(rt, rng, oracle, n_ops=5, base_seed=50)
    stats = rt.stats()
    assert stats["applied_lsn"] == stats["wal_lsn"] >= stats["snapshot_lsn"]
    # crash: abandon rt without stop(); recover from disk alone
    rt2 = ServingRuntime.recover(icfg, str(tmp_path), cfg=rt.cfg,
                                 device="cpu")
    assert rt2.recovery_report.verified
    assert rt2.recovery_report.snapshot_lsn >= 0
    _assert_state_equals_oracle(rt2.index, oracle)
    # recovered node serves and keeps mutating durably
    more = rt2.submit_insert(_data(4, seed=123)).result(WAIT)
    assert rt2.submit_search(_data(2, seed=5)).result(WAIT)[1].shape == (2, 5)
    assert len(more) == 4
    rt2.stop()


def test_recovered_ids_do_not_collide(tmp_path):
    rt, icfg = _runtime(tmp_path)
    ids = rt.submit_insert(_data(6, seed=1)).result(WAIT)
    rt2 = ServingRuntime.recover(icfg, str(tmp_path), cfg=rt.cfg,
                                 device="cpu")
    new = rt2.submit_insert(_data(3, seed=2)).result(WAIT)
    assert set(new).isdisjoint(set(ids))  # allocator cursor recovered
    rt2.stop()


def test_torn_wal_tail_truncated_loudly_on_recovery(tmp_path):
    """With fsync batching (> 1), the newest acked batch can be torn by a
    crash; recovery truncates it loudly and restores the durable prefix."""
    rt, icfg = _runtime(tmp_path, wal_sync_interval=100)
    oracle: dict = {}
    v1 = _data(4, seed=1)
    ids1 = rt.submit_insert(v1).result(WAIT)
    for i, vid in enumerate(ids1):
        oracle[int(vid)] = v1[i]
    last = rt.submit_insert(_data(3, seed=2)).result(WAIT)
    assert len(last) == 3
    # crash tears the final record: drop its last bytes from the active
    # segment (they were acked but never fsynced — the page cache's loss)
    seg = sorted(glob.glob(os.path.join(str(tmp_path), WAL_SUBDIR,
                                        "wal_*.log")))[-1]
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 11)
    index, report = _recover(icfg, tmp_path)
    assert report.torn_tail == 1 and report.verified
    _assert_state_equals_oracle(index, oracle)  # prefix, exactly


def test_recovery_refuses_without_snapshot(tmp_path):
    rt, icfg = _runtime(tmp_path)
    rt.submit_insert(_data(4)).result(WAIT)
    shutil.rmtree(os.path.join(str(tmp_path), SNAP_SUBDIR))
    with pytest.raises(RecoveryError, match="cannot load a snapshot"):
        _recover(icfg, tmp_path)


def test_recovery_refuses_on_pruned_gap(tmp_path):
    rt, icfg = _runtime(tmp_path)
    rt.submit_insert(_data(4, seed=1)).result(WAIT)
    rt._wal.rotate()
    rt.submit_insert(_data(4, seed=2)).result(WAIT)
    wal_dir = os.path.join(str(tmp_path), WAL_SUBDIR)
    os.remove(sorted(glob.glob(os.path.join(wal_dir, "wal_*.log")))[0])
    with pytest.raises(RecoveryError):
        _recover(icfg, tmp_path)


def test_recovery_refuses_on_corrupt_snapshot_bytes(tmp_path):
    rt, icfg = _runtime(tmp_path)
    rt.submit_insert(_data(4)).result(WAIT)
    rt.snapshot(wait=True)
    snap_dir = os.path.join(str(tmp_path), SNAP_SUBDIR)
    shard = sorted(  # newest snapshot (construction published one too)
        glob.glob(os.path.join(snap_dir, "step_*", "shard_0.npz"))
    )[-1]
    with open(shard, "r+b") as f:
        f.seek(os.path.getsize(shard) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(RecoveryError):
        _recover(icfg, tmp_path)


def test_config_mismatch_refuses(tmp_path):
    rt, icfg = _runtime(tmp_path)
    rt.submit_insert(_data(4)).result(WAIT)
    wrong = _index_cfg(block_size=32)  # different pool geometry
    with pytest.raises(RecoveryError):
        _recover(wrong, tmp_path)
    with pytest.raises(RecoveryError, match="config"):  # payload dtype
        _recover(_index_cfg(dtype="bfloat16"), tmp_path)


# ------------------------------------------------------------ crash matrix --
def test_crash_at_wal_append_fails_future_keeps_rest(tmp_path):
    plan = FaultPlan().fail("wal_append", nth=1)  # batch 1 of this run
    rt, icfg = _runtime(tmp_path, faults=plan)
    oracle: dict = {}
    v1 = _data(4, seed=1)
    ids1 = rt.submit_insert(v1).result(WAIT)  # append call 0: fine
    for i, vid in enumerate(ids1):
        oracle[int(vid)] = v1[i]
    with pytest.raises(FaultError):
        rt.submit_insert(_data(3, seed=2)).result(WAIT)  # call 1: dies
    v3 = _data(2, seed=3)
    ids3 = rt.submit_insert(v3).result(WAIT)  # lane recovers
    for i, vid in enumerate(ids3):
        oracle[int(vid)] = v3[i]
    index, report = _recover(icfg, tmp_path)
    assert report.verified
    _assert_state_equals_oracle(index, oracle)


def test_crash_at_wal_fsync_fails_future_keeps_rest(tmp_path):
    plan = FaultPlan().fail("wal_fsync", nth=1)
    rt, icfg = _runtime(tmp_path, faults=plan)
    oracle: dict = {}
    v1 = _data(4, seed=1)
    for i, vid in enumerate(rt.submit_insert(v1).result(WAIT)):
        oracle[int(vid)] = v1[i]
    with pytest.raises(FaultError):
        rt.submit_insert(_data(3, seed=2)).result(WAIT)
    index, report = _recover(icfg, tmp_path)
    assert report.verified
    # the fsync-failed batch was never acked; its record may or may not
    # replay (at-least-once for unacked work) — acked rows must all exist
    got = _live_vectors(index)
    for vid, vec in oracle.items():
        np.testing.assert_array_equal(got[vid], vec)


def test_crash_at_snapshot_publish_keeps_previous_snapshot_and_wal(tmp_path):
    plan = FaultPlan()
    rt, icfg = _runtime(tmp_path, faults=plan)  # publish call 0: initial
    oracle: dict = {}
    v1 = _data(5, seed=1)
    for i, vid in enumerate(rt.submit_insert(v1).result(WAIT)):
        oracle[int(vid)] = v1[i]
    plan.fail("snapshot_publish", nth=1)
    with pytest.raises(FaultError):
        rt.snapshot(wait=True)
    assert rt.stats()["snapshot_failures"] == 1
    # serving continued; WAL intact -> recovery is exact from snapshot 0
    index, report = _recover(icfg, tmp_path)
    assert report.snapshot_lsn == 0 and report.replayed_records >= 1
    _assert_state_equals_oracle(index, oracle)


def test_crash_mid_replay_is_rerecoverable(tmp_path):
    rt, icfg = _runtime(tmp_path)
    oracle: dict = {}
    v1 = _data(6, seed=1)
    for i, vid in enumerate(rt.submit_insert(v1).result(WAIT)):
        oracle[int(vid)] = v1[i]
    rt.submit_delete(np.array(sorted(oracle)[:2], np.int32)).result(WAIT)
    for vid in sorted(oracle)[:2]:
        oracle.pop(vid)
    with pytest.raises(RecoveryError, match="replay failed"):
        _recover(icfg, tmp_path,
                 faults=FaultPlan().fail("recovery_replay", nth=1))
    # recovery never writes to the persist dir: same bytes, second attempt
    index, report = _recover(icfg, tmp_path)
    assert report.verified and report.replayed_records == 2
    _assert_state_equals_oracle(index, oracle)


def test_crash_at_mutation_step_replays_logged_batch(tmp_path):
    """The dispatch died, future failed: the record (if the step logged
    it) is at-least-once — recovery may hold the unacked rows, must hold
    every acked one, and must still verify."""
    plan = FaultPlan().fail("mutation_step", nth=[1])
    rt, icfg = _runtime(tmp_path, faults=plan)
    oracle: dict = {}
    v1 = _data(4, seed=1)
    for i, vid in enumerate(rt.submit_insert(v1).result(WAIT)):
        oracle[int(vid)] = v1[i]
    with pytest.raises(FaultError):
        rt.submit_insert(_data(2, seed=2)).result(WAIT)
    index, report = _recover(icfg, tmp_path)
    assert report.verified
    got = _live_vectors(index)
    for vid, vec in oracle.items():
        np.testing.assert_array_equal(got[vid], vec)


# --------------------------------------------- record/cut atomicity matrix --
def _insert_items(seeds, rows=2):
    """Hand-built multi-item insert run so one _apply_run dispatch carries
    several futures."""
    items, vecs = [], []
    for s in seeds:
        v = _data(rows, seed=100 + s)
        vecs.append(v)
        items.append(_Timed(Future(), time.perf_counter(), v, kind="insert"))
    return items, vecs


def test_isolation_retry_after_failed_append_stays_recoverable(tmp_path):
    """A multi-item run whose append dies at the fsync re-appends per item
    on the isolation retry; the failed record's bytes must have been
    rolled back, or recovery hits duplicate ids."""
    plan = FaultPlan().fail("wal_fsync", nth=1)
    rt, icfg = _runtime(tmp_path, faults=plan)
    oracle: dict = {}
    v0 = _data(2, seed=0)
    for i, vid in enumerate(rt.submit_insert(v0).result(WAIT)):  # fsync 0
        oracle[int(vid)] = v0[i]
    # one run of three items: the run's own append dies (fsync 1), the
    # per-item retries append their own records (fsyncs 2..4) and all ack
    items, vecs = _insert_items([1, 2, 3])
    rt._apply_run(items)
    for it, v in zip(items, vecs):
        for i, vid in enumerate(it.future.result(WAIT)):
            oracle[int(vid)] = v[i]
    assert rt.stats()["isolations"] == 1
    # crash: abandon rt; the log must replay without duplicate ids
    index, report = _recover(icfg, tmp_path)
    assert report.verified
    _assert_state_equals_oracle(index, oracle)


def test_snapshot_cut_waits_for_inflight_record(tmp_path):
    """The cut must wait out an in-flight record's append->apply->fence
    sequence (that is what makes the fence trustworthy)."""
    rt, _ = _runtime(tmp_path)
    rt.submit_insert(_data(4, seed=1)).result(WAIT)
    assert rt._record_lock.acquire(timeout=5)  # simulate a mid-record apply
    try:
        t = threading.Thread(target=rt.snapshot, kwargs={"wait": True})
        t.start()
        t.join(0.5)
        assert t.is_alive(), "snapshot cut while a record was in flight"
    finally:
        rt._record_lock.release()
    t.join(WAIT)
    assert not t.is_alive()
    s = rt.stats()
    assert s["snapshot_lsn"] == s["applied_lsn"] == s["wal_lsn"]
    rt.stop()


def test_cut_never_lands_inside_a_retried_record(tmp_path):
    """A logged run fails after its append and retries per item; a
    snapshot racing the retry loop must not cut between items — it would
    fence a half-applied record and recovery would silently drop rows
    acked after the cut."""
    rt, icfg = _runtime(tmp_path)
    oracle: dict = {}

    calls = {"step": 0}
    real_step = rt._insert_step

    def flaky_step(args, record):
        calls["step"] += 1
        if calls["step"] == 1:  # the whole-run dispatch
            with rt._write_lock:
                record()  # the run is logged, as a real step logs it
            raise RuntimeError("injected device failure after the append")
        return real_step(args, record)

    rt._insert_step = _Step(flaky_step)

    snap: dict = {}
    real_args = rt._mutation_args

    def racing_args(kind, items, ids=None):
        # second retry item of the logged run: race a snapshot against
        # the remainder of the loop and give it a wide-open window
        if ids is not None and calls["step"] == 2 and "t" not in snap:
            t = threading.Thread(target=rt.snapshot, kwargs={"wait": True})
            t.start()
            snap["t"] = t
            time.sleep(0.3)  # unfixed code: the cut lands here, mid-record
        return real_args(kind, items, ids=ids)

    rt._mutation_args = racing_args

    items, vecs = _insert_items([1, 2, 3])
    rt._apply_run(items)
    for it, v in zip(items, vecs):
        for i, vid in enumerate(it.future.result(WAIT)):
            oracle[int(vid)] = v[i]
    snap["t"].join(WAIT)
    assert not snap["t"].is_alive()
    # the retries appended nothing: the run's one record covers them
    assert rt.stats()["wal_lsn"] == 1
    # crash: the snapshot (plus whatever WAL survived its prune) must
    # rebuild every acked row — a mid-record cut loses the loop's tail
    index, report = _recover(icfg, tmp_path)
    assert report.verified
    _assert_state_equals_oracle(index, oracle)


def test_plain_constructor_refuses_used_persist_dir(tmp_path):
    """Constructing a fresh runtime over a directory that already holds
    snapshots/WAL would fork the log from the in-memory index — enforced
    with a named error, not a config comment."""
    rt, icfg = _runtime(tmp_path)
    rt.submit_insert(_data(3, seed=1)).result(WAIT)
    rt.stop()
    with pytest.raises(PersistDirConflict, match="recover"):
        _runtime(tmp_path)
    rt2 = ServingRuntime.recover(icfg, str(tmp_path), device="cpu")
    assert rt2.recovery_report.verified
    rt2.stop()


# ------------------------------------------------------------ port's own --
class _Watched:
    """A runtime lock, noting each thread that comes to take it before it
    blocks there."""

    def __init__(self, lock):
        self.lock = lock
        self.entering: list = []

    def locked(self) -> bool:
        return self.lock.locked()

    def acquire(self, *a, **k):
        self.entering.append(threading.current_thread())
        return self.lock.acquire(*a, **k)

    def release(self):
        return self.lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def _until(cond, what: str):
    t_end = time.perf_counter() + WAIT
    while not cond():
        assert time.perf_counter() < t_end, what
        time.sleep(0.002)


@pytest.mark.parametrize("mode", ["parallel", "fused"])
def test_append_holds_the_writer_out_and_precedes_the_front(tmp_path,
                                                            monkeypatch,
                                                            mode):
    """The append comes under the single-writer hold, before the step's
    read-only front: while it is parked at ``wal_append``, a compaction
    pass waits at ``_write_lock`` and a snapshot cut at ``_record_lock``,
    and the front (cluster assignment) has not run.  Released, the run
    applies, the cut fences after it, and recovery gives the acked rows."""
    from repro_torch.core import runtime as rtmod

    go, parked = threading.Event(), threading.Event()

    class _Park(FaultPlan):
        def check(self, site):
            if site == "wal_append" and parked.is_set() is False \
                    and self.calls("wal_append") == 1:
                parked.set()
                assert go.wait(WAIT), "the append was never released"
            super().check(site)

    rt, icfg = _runtime(tmp_path, faults=_Park(), mode=mode, flush_min=1,
                        flush_interval=0.02)
    fronts = []
    real_assign = rtmod.assign_clusters
    monkeypatch.setattr(rtmod, "assign_clusters",
                        lambda *a: fronts.append(1) or real_assign(*a))
    oracle: dict = {}
    v0 = _data(3, seed=1)
    for i, vid in enumerate(rt.submit_insert(v0).result(WAIT)):  # append 0
        oracle[int(vid)] = v0[i]
    rt._write_lock = _Watched(rt._write_lock)
    rt._record_lock = _Watched(rt._record_lock)
    if mode == "fused":  # pair the insert with a search
        srch = rt.submit_search(_data(1, seed=3))
    v1 = _data(4, seed=2)
    fut = rt.submit_insert(v1)  # append 1: parked
    assert parked.wait(WAIT)
    n_fronts = len(fronts)
    compactor = threading.Thread(target=rt._maybe_compact)
    cutter = threading.Thread(target=rt.snapshot, kwargs={"wait": True})
    compactor.start()
    cutter.start()
    try:
        _until(lambda: compactor in rt._write_lock.entering,
               "the compaction pass never came to the writer lock")
        _until(lambda: cutter in rt._record_lock.entering,
               "the cut never came to the record lock")
        time.sleep(0.05)
        assert compactor.is_alive() and cutter.is_alive()
        assert len(fronts) == n_fronts  # the front waits for the append
    finally:
        go.set()
    compactor.join(WAIT)
    cutter.join(WAIT)
    assert not compactor.is_alive() and not cutter.is_alive()
    for i, vid in enumerate(fut.result(WAIT)):
        oracle[int(vid)] = v1[i]
    if mode == "fused":
        srch.result(WAIT)
    s = rt.stats()
    assert s["snapshot_lsn"] == s["applied_lsn"] == s["wal_lsn"] == 2
    index, report = _recover(icfg, tmp_path)
    assert report.verified and report.replayed_records == 0
    _assert_state_equals_oracle(index, oracle)
    rt.stop()


def test_host_copy_never_aliases_the_live_state():
    """The snapshot's host copy is published on a background thread while
    the steps go on writing the state in place; on a CPU index a plain
    ``.cpu()`` would hand back the live tensors, and the published bytes
    (and their CRCs) would change under the writer."""
    idx = _fresh_index(_index_cfg())
    idx.add(_data(20, seed=4))
    arrays, dtypes = host_copy(idx.state)
    before = {k: v.copy() for k, v in arrays.items()}
    idx.add(_data(20, seed=5))
    idx.delete(np.arange(5, dtype=np.int32))
    for name, arr in arrays.items():
        assert not np.shares_memory(arr, getattr(idx.state, name).numpy())
        np.testing.assert_array_equal(arr, before[name], err_msg=name)
    assert dtypes["pool_payload"] == "float32"


# ---------------------------------------------------------- property test --
def _durability_property(seed: int, tmp_path):
    """Random mutation sequence, crash at a random point (plain kill /
    mid-snapshot / mid-replay), recovered state == acked oracle exactly."""
    rng = np.random.default_rng(seed)
    root = os.path.join(str(tmp_path), f"run_{seed}")
    plan = FaultPlan()
    rt, icfg = _runtime(root, faults=plan)
    oracle: dict = {}
    n_ops = int(rng.integers(6, 14))
    snap_at = int(rng.integers(0, n_ops)) if rng.random() < 0.7 else -1
    for op in range(n_ops):
        if op == snap_at:
            rt.snapshot(wait=True)
        _drive(rt, rng, oracle, n_ops=1, base_seed=seed * 100 + op)
    crash_kind = rng.choice(["kill", "mid_snapshot", "mid_replay"])
    if crash_kind == "mid_snapshot":
        plan.fail("snapshot_publish", nth=plan.calls("snapshot_publish"))
        with pytest.raises(FaultError):
            rt.snapshot(wait=True)
    # crash: abandon the runtime, recover from disk
    if crash_kind == "mid_replay":
        try:
            _recover(icfg, root,
                     faults=FaultPlan().fail("recovery_replay", nth=0))
        except RecoveryError:
            pass  # died mid-replay; fall through to the real recovery
    index, report = _recover(icfg, root)
    assert report.verified
    _assert_state_equals_oracle(index, oracle)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=8, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=2**20))
    def test_durability_property(seed, tmp_path_factory):
        _durability_property(
            seed, tmp_path_factory.mktemp(f"prop_{seed}")
        )

except ImportError:  # no hypothesis in this environment: seeded fallback
    @pytest.mark.parametrize("seed", [3, 11, 42, 1337])
    def test_durability_property(seed, tmp_path):
        _durability_property(seed, tmp_path)
