"""Mutation write-ahead log: the durability floor of the online index.

Every admitted insert/delete/update batch is appended here *before* the
device apply (see ``ServingRuntime._apply_run``), so a ``kill -9`` at any
instant loses at most work that was never acknowledged.  Acks happen after
the apply, which happens after the append — with the default
``sync_interval=1`` (fsync per appended batch) the acked set is always a
subset of the durable set: **RPO = 0 acked rows**.  Larger intervals batch
the fsync across appends and trade that guarantee for throughput (up to
``interval - 1`` most-recent batches may be acked-but-volatile; see
docs/serving_ops.md "fsync interval tradeoff").

On-disk layout: a directory of segment files ``wal_<seq>.log``.  Each
segment is an 8-byte header (magic + format version) followed by
length-prefixed records:

    u32 payload_len | u32 crc32 | u64 lsn | u8 kind | 3x pad | payload

The CRC32 covers everything after itself (lsn, kind, pad, payload), so a
torn tail — the page cache's half-written last record after power loss —
fails loudly instead of replaying garbage.  LSNs are assigned by
``append`` and are strictly monotonically increasing across segments;
``rotate()`` (called by the snapshot barrier) seals the active segment so
``prune(lsn)`` can drop whole segments once a published snapshot covers
them — the WAL is truncated only *after* the snapshot publish succeeds.

Record payloads are raw little-endian arrays (ids i32, vectors f32), not
pickles: replay of a hostile or corrupt log can fail a CRC, never execute
code.  A batch may fail *between* append and apply (injected fault, device
error): its record still replays on recovery.  That is at-least-once
delivery of never-acked work — inserts mint fresh ids per submit, deletes
are idempotent, updates are last-write-wins, so replaying it is always
safe.

A failed *append* (transient ENOSPC/EIO, failed fsync) is rolled back:
the segment is truncated to the end of its last good record before the
error propagates, so a retry's re-append can never collide with the dead
record's bytes (duplicate rows, or garbage that a later scan reads as
mid-log corruption).  If even the rollback fails, the log fails closed —
:class:`WALUnavailable` on every further append — instead of writing
past an untrusted tail.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import struct
import threading
import zlib
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.faults import NO_FAULTS, FaultPlan
from repro_torch.obs.events import EV_WAL_FSYNC, EV_WAL_ROTATE

log = logging.getLogger(__name__)

# ---- file-format constants (cache-key-relevant config: changing any of
# ---- these is a format break — bump WAL_VERSION and teach replay; the
# ---- persist-format lint rule keeps them named, never inline) -----------
WAL_MAGIC = b"RWAL"
WAL_VERSION = 1
SEG_HEADER_FMT = "<4sHH"  # magic, version, reserved
SEG_HEADER_LEN = struct.calcsize(SEG_HEADER_FMT)  # 8
REC_LEN_CRC_FMT = "<II"  # payload_len, crc32 (not covered by the crc)
REC_LEN_CRC_LEN = struct.calcsize(REC_LEN_CRC_FMT)  # 8
REC_TAIL_FMT = "<QB3x"  # lsn, kind, pad (crc-covered, with the payload)
REC_HEADER_FMT = "<IIQB3x"  # the two of those, as read back in one go
REC_HEADER_LEN = struct.calcsize(REC_HEADER_FMT)  # 20
PAYLOAD_HEADER_FMT = "<II"  # n_rows, dim (0 for delete)
PAYLOAD_HEADER_LEN = struct.calcsize(PAYLOAD_HEADER_FMT)  # 8
#: kind byte <-> mutation kind (order matches core.mutate.REPLAY_KINDS)
KIND_CODES = {"insert": 0, "delete": 1, "update": 2}
KIND_NAMES = {v: k for k, v in KIND_CODES.items()}
_SEG_PREFIX = "wal_"
_SEG_SUFFIX = ".log"


class WALCorruption(RuntimeError):
    """A WAL segment failed validation somewhere other than its tail —
    unlike a torn tail (a normal crash artifact, truncated loudly), this
    means lost or mangled history and recovery must refuse to serve."""


class WALUnavailable(RuntimeError):
    """The append side failed closed: a failed append could not be rolled
    back, so the active segment's tail is untrusted.  Writing past it
    would bury garbage mid-log — unrecoverable corruption instead of a
    truncatable tail — so every further append/rotate raises this until
    the log is re-opened (which repairs the tail by CRC)."""


@dataclasses.dataclass(frozen=True)
class WALRecord:
    """One durably logged mutation batch."""

    lsn: int
    kind: str  # insert | delete | update
    ids: np.ndarray  # [n] i32
    vectors: Optional[np.ndarray]  # [n, d] f32 (insert/update) | None
    nbytes: int = 0  # on-disk size incl. record header (tail repair)

    @property
    def rows(self) -> int:
        return len(self.ids)


def encode_record(lsn: int, kind: str, ids: np.ndarray,
                  vectors: Optional[np.ndarray]) -> bytes:
    ids = np.ascontiguousarray(ids, dtype="<i4")
    n = len(ids)
    if kind == "delete":
        if vectors is not None:
            raise ValueError("delete records carry no vectors")
        body = struct.pack(PAYLOAD_HEADER_FMT, n, 0) + ids.tobytes()
    else:
        vectors = np.ascontiguousarray(vectors, dtype="<f4")
        if vectors.ndim != 2 or len(vectors) != n:
            raise ValueError(f"{kind}: {n} ids for vectors {vectors.shape}")
        body = (
            struct.pack(PAYLOAD_HEADER_FMT, n, vectors.shape[1])
            + ids.tobytes()
            + vectors.tobytes()
        )
    tail = struct.pack(REC_TAIL_FMT, lsn, KIND_CODES[kind]) + body
    crc = zlib.crc32(tail)
    return struct.pack(REC_LEN_CRC_FMT, len(body), crc) + tail


def _decode_payload(
    kind: str, body: bytes
) -> "tuple[np.ndarray, Optional[np.ndarray]]":
    n, dim = struct.unpack_from(PAYLOAD_HEADER_FMT, body, 0)
    off = PAYLOAD_HEADER_LEN
    ids = np.frombuffer(body, dtype="<i4", count=n, offset=off).astype(
        np.int32
    )
    if kind == "delete":
        return ids, None
    off += ids.itemsize * n
    vec = np.frombuffer(body, dtype="<f4", count=n * dim, offset=off)
    return ids, vec.reshape(n, dim).astype(np.float32)


def iter_segment(path: str) -> "Iterator[WALRecord | str]":
    """Yield records of one segment; on a torn/corrupt record, yield one
    final ``str`` describing the damage and stop (the caller decides
    whether that is a legal crash tail or corruption)."""
    with open(path, "rb") as f:
        head = f.read(SEG_HEADER_LEN)
        if len(head) < SEG_HEADER_LEN:
            yield f"{path}: short segment header"
            return
        magic, version, _ = struct.unpack(SEG_HEADER_FMT, head)
        if magic != WAL_MAGIC:
            yield f"{path}: bad magic {magic!r}"
            return
        if version != WAL_VERSION:
            yield f"{path}: WAL format version {version} != {WAL_VERSION}"
            return
        while True:
            hdr = f.read(REC_HEADER_LEN)
            if not hdr:
                return  # clean end
            if len(hdr) < REC_HEADER_LEN:
                yield f"{path}: torn record header ({len(hdr)} bytes)"
                return
            body_len, crc, lsn, kind_code = struct.unpack(
                REC_HEADER_FMT, hdr
            )
            body = f.read(body_len)
            if len(body) < body_len:
                yield (f"{path}: torn record body @ lsn {lsn} "
                       f"({len(body)}/{body_len} bytes)")
                return
            if zlib.crc32(hdr[REC_LEN_CRC_LEN:] + body) != crc:
                yield f"{path}: CRC mismatch @ lsn {lsn}"
                return
            kind = KIND_NAMES.get(kind_code)
            if kind is None:
                yield f"{path}: unknown record kind {kind_code} @ lsn {lsn}"
                return
            ids, vectors = _decode_payload(kind, body)
            yield WALRecord(
                lsn=lsn, kind=kind, ids=ids, vectors=vectors,
                nbytes=REC_HEADER_LEN + body_len,
            )


def _segment_paths(directory: str) -> "list[str]":
    if not os.path.isdir(directory):
        return []
    names = sorted(
        d for d in os.listdir(directory)
        if d.startswith(_SEG_PREFIX) and d.endswith(_SEG_SUFFIX)
    )
    return [os.path.join(directory, d) for d in names]


def read_wal(
    directory: str, min_lsn: int = 0
) -> "tuple[list[WALRecord], dict]":
    """Scan every segment in order; return the records with
    ``lsn > min_lsn`` plus a report dict.

    A torn/CRC-failing record is a legal crash artifact only at the very
    tail of the *last* segment: there it is truncated loudly (logged,
    counted in ``report['torn_tail']``).  Anywhere else it means lost
    history — :class:`WALCorruption`.
    """
    paths = _segment_paths(directory)
    records: list[WALRecord] = []
    report = {
        "segments": len(paths),
        "scanned_records": 0,
        "torn_tail": 0,
        "torn_detail": None,
    }
    for i, path in enumerate(paths):
        for item in iter_segment(path):
            if isinstance(item, str):
                if i != len(paths) - 1:
                    raise WALCorruption(
                        f"damage in a non-final segment: {item}"
                    )
                log.warning("WAL tail truncated: %s", item)
                report["torn_tail"] += 1
                report["torn_detail"] = item
                break
            report["scanned_records"] += 1
            if item.lsn > min_lsn:
                records.append(item)
    for a, b in zip(records, records[1:]):
        if b.lsn != a.lsn + 1:
            raise WALCorruption(
                f"LSN gap in WAL: {a.lsn} -> {b.lsn} (records lost)"
            )
    return records, report


class MutationWAL:
    """Append-side handle.  Thread-safe; one writer process per directory.

    ``sync_interval`` counts *appends* between fsyncs (1 = every batch).
    ``append`` and ``sync`` check the ``wal_append`` / ``wal_fsync`` fault
    sites so tests can crash the process model at either point.
    """

    def __init__(self, directory: str, sync_interval: int = 1,
                 faults: Optional[FaultPlan] = None, start_lsn: int = 0,
                 recorder=None):
        """``start_lsn`` is the LSN floor — the owning runtime passes its
        latest snapshot fence.  Without it, reopening a log whose segments
        were all pruned (fence == last LSN) would restart numbering at 1
        and the new records would collide with — and be filtered out
        below — the fence: silent loss of everything after the reopen."""
        if sync_interval < 1:
            raise ValueError(f"sync_interval must be >= 1: {sync_interval}")
        self.dir = directory
        self.sync_interval = sync_interval
        self._faults = faults if faults is not None else NO_FAULTS
        # optional flight recorder (repro_torch.obs.events.FlightRecorder):
        # the owning runtime passes its own so fsync/rotate land on the same
        # timeline as the control-plane transitions.  record_event takes
        # only the recorder's leaf lock, so calling it under _lock is safe.
        self._recorder = recorder
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._file = None  # guarded-by: _lock
        self._path = ""  # guarded-by: _lock
        self._sealed: list = []  # guarded-by: _lock — (path, last_lsn)
        self._seq = 0  # guarded-by: _lock
        self._seg_count = 0  # guarded-by: _lock — records in active segment
        self._last_lsn = 0  # guarded-by: _lock
        self._durable_lsn = 0  # guarded-by: _lock
        self._unsynced = 0  # guarded-by: _lock
        self._failed = False  # guarded-by: _lock — rollback failed: closed
        with self._lock:
            self._adopt_existing()
            self._last_lsn = max(self._last_lsn, int(start_lsn))
            self._durable_lsn = self._last_lsn
            self._open_segment()

    # ------------------------------------------------------------ open ---
    def _adopt_existing(self):  # holds: _lock
        """Continue LSNs after the existing log (recovery hand-off).  A
        torn tail in the last segment is *repaired* here — truncated to
        the end of its last good record — so later scans never mistake
        the healed crash artifact for mid-log corruption."""
        paths = _segment_paths(self.dir)
        for i, path in enumerate(paths):
            last, good_bytes, damage = 0, SEG_HEADER_LEN, None
            for item in iter_segment(path):
                if isinstance(item, str):
                    damage = item
                    break
                last = item.lsn
                good_bytes += item.nbytes
            if damage is not None:
                if i != len(paths) - 1:
                    raise WALCorruption(
                        f"damage in a non-final segment: {damage}"
                    )
                log.warning(
                    "repairing torn WAL tail (%s): truncating %s to %d "
                    "bytes", damage, path, good_bytes,
                )
                with open(path, "r+b") as f:
                    f.truncate(good_bytes)
            name = os.path.basename(path)
            self._seq = max(
                self._seq,
                int(name[len(_SEG_PREFIX): -len(_SEG_SUFFIX)]),
            )
            if last:
                self._sealed.append((path, last))
                self._last_lsn = max(self._last_lsn, last)
            else:
                os.remove(path)  # held no intact record: drop it
        self._durable_lsn = self._last_lsn

    def _open_segment(self):  # holds: _lock
        self._seq += 1
        path = os.path.join(
            self.dir, f"{_SEG_PREFIX}{self._seq:010d}{_SEG_SUFFIX}"
        )
        self._file = open(path, "xb")
        self._file.write(
            struct.pack(SEG_HEADER_FMT, WAL_MAGIC, WAL_VERSION, 0)
        )
        self._file.flush()
        self._path = path
        self._seg_count = 0

    # ---------------------------------------------------------- append ---
    def append(self, kind: str, ids: np.ndarray,
               vectors: Optional[np.ndarray] = None) -> int:
        """Durably stage one mutation batch; returns its LSN.  Raises if
        the write or a due fsync fails — the caller must then *not* apply
        the batch.  A failed append is *rolled back*: the segment is
        truncated to the end of its last good record and the LSN counter
        restored, so the dead record's bytes cannot linger and collide
        with the retry's re-append (duplicate rows, or mid-log garbage
        that recovery cannot distinguish from lost history).  If even the
        rollback fails, the log fails closed (:class:`WALUnavailable` on
        every later append) instead of writing past an untrusted tail."""
        self._faults.check("wal_append")
        with self._lock:
            self._ensure_open()
            saved = (self._last_lsn, self._seg_count, self._unsynced)
            pos = self._file.tell()
            lsn = self._last_lsn + 1
            try:
                self._file.write(encode_record(lsn, kind, ids, vectors))
                self._last_lsn = lsn
                self._seg_count += 1
                self._unsynced += 1
                if self._unsynced >= self.sync_interval:
                    self._sync_locked()
                else:
                    self._file.flush()  # page cache; fsync is batched
            except Exception:
                self._last_lsn, self._seg_count, self._unsynced = saved
                self._rollback_locked(pos)
                raise
        return lsn

    def _ensure_open(self):  # holds: _lock
        if self._failed:
            raise WALUnavailable(
                f"{self._path}: a failed append could not be rolled back; "
                "refusing to write past an untrusted tail (re-open the "
                "log to repair it)"
            )

    def _rollback_locked(self, pos: int):  # holds: _lock
        """Truncate the active segment back to ``pos`` (the end of its
        last good record) after a failed append.  The seek flushes any
        half-buffered bytes first; the truncate then cuts them and the
        failed record together.  Failure here fails the log closed —
        see ``append``."""
        try:
            self._file.seek(pos)
            self._file.truncate(pos)
            self._file.flush()
        except Exception:
            self._failed = True
            log.exception(
                "WAL rollback to offset %d of %s failed; the log is "
                "failing closed", pos, self._path,
            )

    def _sync_locked(self):  # holds: _lock
        self._faults.check("wal_fsync")
        self._file.flush()
        os.fsync(self._file.fileno())
        self._durable_lsn = self._last_lsn
        self._unsynced = 0
        if self._recorder is not None:
            self._recorder.record_event(
                EV_WAL_FSYNC, durable_lsn=self._durable_lsn
            )

    def sync(self) -> int:
        """Force an fsync now; returns the durable LSN."""
        with self._lock:
            if self._unsynced:
                self._sync_locked()
            return self._durable_lsn

    # ----------------------------------------------------- snapshotting --
    def rotate(self) -> int:
        """Seal the active segment and start a fresh one (the snapshot
        barrier calls this so ``prune`` can later drop whole sealed
        segments).  Returns the WAL's last LSN."""
        with self._lock:
            self._ensure_open()  # sealing an untrusted tail buries garbage
            if self._unsynced:
                self._sync_locked()
            self._file.close()
            if self._seg_count:
                self._sealed.append((self._path, self._last_lsn))
            else:
                os.remove(self._path)  # never held a record
            self._open_segment()
            if self._recorder is not None:
                self._recorder.record_event(
                    EV_WAL_ROTATE, last_lsn=self._last_lsn,
                    sealed_segments=len(self._sealed),
                )
            return self._last_lsn

    def prune(self, upto_lsn: int) -> int:
        """Delete sealed segments whose every record has
        ``lsn <= upto_lsn`` (i.e. is covered by a *published* snapshot).
        Only call after the publish succeeded.  Returns #segments dropped."""
        with self._lock:
            keep, dropped = [], 0
            for path, last in self._sealed:
                if last <= upto_lsn:
                    os.remove(path)
                    dropped += 1
                else:
                    keep.append((path, last))
            self._sealed = keep
            return dropped

    # ------------------------------------------------------------ state --
    @property
    def last_lsn(self) -> int:
        with self._lock:
            return self._last_lsn

    @property
    def durable_lsn(self) -> int:
        with self._lock:
            return self._durable_lsn

    def lsns(self) -> "tuple[int, int]":
        """``(last_lsn, durable_lsn)`` as ONE consistent read.  Reading
        the two properties back-to-back takes the lock twice; an append +
        fsync landing between them yields a pair (stale last, fresh
        durable) where ``durable > last`` — nonsense under the LSN
        contract.  ``stats()`` reads through here."""
        with self._lock:
            return self._last_lsn, self._durable_lsn

    def close(self):
        with self._lock:
            if self._file is not None and not self._file.closed:
                if self._unsynced:
                    try:
                        self._sync_locked()
                    except Exception:  # close must not mask a shutdown path
                        log.exception("WAL final fsync failed")
                self._file.close()
