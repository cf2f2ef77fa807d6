"""Verified recovery: snapshot + WAL replay -> a serving-ready index.

The reference's recovery in PyTorch.  The contract (docs/serving_ops.md
"recovery runbook"):

1. load the newest published snapshot (CRC-verified per leaf, schema
   checked) and its LSN fence;
2. replay exactly the WAL records with ``lsn > fence``, in LSN order,
   through the *same* batch steps the online lane dispatches
   (``core.mutate.make_replay_fns``), each record padded to its pow2
   bucket on the host and copied to the device once — a torn/CRC-failing
   tail is truncated loudly and counted, any other damage refuses
   recovery;
3. verify before accepting traffic: ``check_invariants`` over the full
   pool plus a sampled id_map <-> pool_live cross-check (both directions).

Every refusal raises :class:`RecoveryError` with the cause chained — a
node that cannot prove its recovered state is exactly the acked history
must not serve approximate answers from it.  Recovery itself never writes
to the persist directory (WAL tail repair happens later, when the runtime
re-opens the log), so a crash mid-replay — injectable at the
``recovery_replay`` site — is re-recoverable from the same bytes.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core import pq as pqmod
from repro_torch.core.block_pool import NULL, check_invariants
from repro_torch.core.faults import NO_FAULTS, FaultPlan
from repro_torch.core.ivf import IVFIndex, IVFIndexConfig
from repro_torch.core.mutate import make_replay_fns
from repro_torch.persist import snapshot as snapmod
from repro_torch.persist.snapshot import SNAP_SUBDIR, WAL_SUBDIR
from repro_torch.persist.wal import read_wal

log = logging.getLogger(__name__)


class RecoveryError(RuntimeError):
    """Recovery could not prove the restored state matches the acked
    history — the node must refuse to serve, not guess.

    When raised by :func:`recover_index`, carries the partially-filled
    :class:`RecoveryReport` as ``report`` (how far recovery got)."""

    report: "Optional[RecoveryReport]" = None


@dataclasses.dataclass
class RecoveryReport:
    """What recovery did, for operators and the property tests."""

    snapshot_lsn: int = 0
    replayed_records: int = 0
    replayed_rows: int = 0
    last_lsn: int = 0
    next_id: int = 0
    wal_segments: int = 0
    torn_tail: int = 0
    torn_detail: Optional[str] = None
    sampled_ids_checked: int = 0
    sampled_slots_checked: int = 0
    verified: bool = False

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _pad_batch(ids: np.ndarray, vectors: Optional[np.ndarray], dim: int,
               device: torch.device):
    """Pad a replayed batch to its power-of-two bucket on the host — the
    same bucket discipline the serving runtime uses — then copy each
    padded array to ``device`` once."""
    n = len(ids)
    b = _pow2_bucket(n)
    pid = np.full((b,), NULL, np.int32)
    pid[:n] = ids
    valid = np.zeros((b,), bool)
    valid[:n] = True
    if vectors is None:  # a delete: the step ignores its vectors
        vec = torch.zeros((b, dim), dtype=torch.float32, device=device)
    else:
        pv = np.zeros((b, dim), np.float32)
        pv[:n] = vectors
        vec = torch.from_numpy(pv).to(device)
    return (torch.from_numpy(pid).to(device), vec,
            torch.from_numpy(valid).to(device))


def verify_index(index: IVFIndex, report: RecoveryReport,
                 sample: int = 256, seed: int = 0) -> None:
    """Invariant sweep + sampled cross-check; raises RecoveryError.

    ``check_invariants`` walks every chain (structure, lengths, free-stack
    disjointness).  The sampled pass cross-checks the two residency maps
    against each other: a forward pass (id_map entry -> slot must be live
    and hold that id) and a reverse pass (live slot -> its id must map
    back to it).  A snapshot/replay divergence that kept both structures
    self-consistent but *disagreeing* — e.g. a replayed delete lost on one
    side — is exactly what this catches."""
    state, cfg = index.state, index.pool_cfg
    try:
        check_invariants(state, cfg)
    except AssertionError as e:
        raise RecoveryError(
            f"recovered state failed check_invariants: {e}"
        ) from e
    host_map = state.id_map.cpu().numpy()
    host_live = state.pool_live.cpu().numpy()
    host_ids = state.pool_ids.cpu().numpy()
    tm = cfg.block_size
    rng = np.random.default_rng(seed)

    mapped = np.flatnonzero(host_map != NULL)
    if len(mapped) > sample:
        mapped = rng.choice(mapped, size=sample, replace=False)
    for vid in mapped:
        loc = int(host_map[vid])
        blk, off = divmod(loc, tm)
        if not host_live[blk, off]:
            raise RecoveryError(
                f"id_map[{int(vid)}] -> slot {loc}, but pool_live says the "
                "slot is dead — id map and tombstone mask diverged"
            )
        if int(host_ids[blk, off]) != int(vid):
            raise RecoveryError(
                f"id_map[{int(vid)}] -> slot {loc}, but the slot holds id "
                f"{int(host_ids[blk, off])} — id map points at a stolen slot"
            )
    report.sampled_ids_checked = int(len(mapped))

    live_slots = np.flatnonzero(host_live.ravel())
    if len(live_slots) > sample:
        live_slots = rng.choice(live_slots, size=sample, replace=False)
    for loc in live_slots:
        blk, off = divmod(int(loc), tm)
        vid = int(host_ids[blk, off])
        if vid == NULL:
            raise RecoveryError(
                f"slot {int(loc)} is live but holds NULL id"
            )
        if vid >= len(host_map) or int(host_map[vid]) != int(loc):
            raise RecoveryError(
                f"slot {int(loc)} holds id {vid} but id_map[{vid}] = "
                f"{int(host_map[vid]) if vid < len(host_map) else 'out-of-range'}"
                " — a live row is unreachable by id"
            )
    report.sampled_slots_checked = int(len(live_slots))
    report.verified = True


def recover_index(
    cfg: IVFIndexConfig,
    persist_dir: str,
    *,
    faults: Optional[FaultPlan] = None,
    sample: int = 256,
    device=None,
) -> "tuple[IVFIndex, RecoveryReport]":
    """The whole recovery pipeline; the only way back from a crash.

    Returns a verified, serving-ready :class:`IVFIndex` on ``device`` (the
    card unless the caller names one) plus the report.
    Raises :class:`RecoveryError` (cause chained) on anything it cannot
    prove — missing snapshot, schema/CRC failure, mid-log corruption, LSN
    gap, replay failure, invariant violation.  The raised error carries
    the partially-filled report as ``e.report`` — how far recovery got
    before it refused — which the runtime's recovery-failure debug bundle
    (``repro_torch.obs.bundle``) persists for the post-mortem.
    """
    plan = faults if faults is not None else NO_FAULTS
    report = RecoveryReport()
    try:
        return _recover_index(cfg, persist_dir, plan, report, sample,
                              device)
    except RecoveryError as e:
        e.report = report
        raise


def _recover_index(
    cfg: IVFIndexConfig,
    persist_dir: str,
    plan: FaultPlan,
    report: RecoveryReport,
    sample: int,
    device,
) -> "tuple[IVFIndex, RecoveryReport]":
    index = IVFIndex(cfg, device=device)
    snap_dir = os.path.join(persist_dir, SNAP_SUBDIR)
    wal_dir = os.path.join(persist_dir, WAL_SUBDIR)

    try:
        state, pq, manifest = snapmod.load_latest(
            snap_dir, device=index.device
        )
    except Exception as e:
        raise RecoveryError(f"cannot load a snapshot: {e}") from e
    snap_lsn = int(manifest[snapmod.SNAP_LSN_KEY])
    next_id = int(manifest[snapmod.SNAP_NEXT_ID_KEY])
    report.snapshot_lsn = report.last_lsn = snap_lsn

    try:
        records, wal_report = read_wal(wal_dir, min_lsn=snap_lsn)
    except Exception as e:
        raise RecoveryError(f"WAL unreadable past lsn {snap_lsn}: {e}") from e
    report.wal_segments = wal_report["segments"]
    report.torn_tail = wal_report["torn_tail"]
    report.torn_detail = wal_report["torn_detail"]
    if records and records[0].lsn != snap_lsn + 1:
        raise RecoveryError(
            f"WAL starts at lsn {records[0].lsn} but the snapshot fence is "
            f"{snap_lsn} — records {snap_lsn + 1}..{records[0].lsn - 1} "
            "were pruned without a covering snapshot"
        )

    try:
        index.install_state(state, pq=pq, next_id=next_id)
    except Exception as e:
        raise RecoveryError(f"snapshot does not fit this config: {e}") from e

    encode = pqmod.make_pq_encode_fn(pq) if pq is not None else None
    replay = make_replay_fns(index.pool_cfg, encode=encode)
    dim = index.pool_cfg.dim
    cur = index.state
    max_id = next_id - 1
    try:
        for rec in records:
            plan.check("recovery_replay")
            ids, vec, valid = _pad_batch(
                rec.ids, rec.vectors, dim, index.device
            )
            cur = replay[rec.kind](cur, vec, ids, valid)
            report.replayed_records += 1
            report.replayed_rows += rec.rows
            report.last_lsn = rec.lsn
            if rec.kind != "delete" and rec.rows:
                max_id = max(max_id, int(rec.ids.max()))
    except Exception as e:
        raise RecoveryError(
            f"replay failed at lsn {report.last_lsn + 1}: {e}"
        ) from e
    index.state = cur
    # replayed inserts minted ids past the snapshot's allocator cursor
    index._next_id = max_id + 1
    report.next_id = max_id + 1

    verify_index(index, report, sample=sample, seed=cfg.seed)
    log.info(
        "recovered: snapshot lsn %d + %d replayed records (%d rows), "
        "verified", snap_lsn, report.replayed_records, report.replayed_rows,
    )
    return index, report
