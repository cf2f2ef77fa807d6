"""Durability for the online index: mutation WAL, crash-consistent
snapshots, verified recovery — the reference's, with its on-disk formats,
so a persist directory written by either package recovers in the other.
See docs/serving_ops.md "Durability"."""

from repro_torch.persist.recovery import (
    SNAP_SUBDIR,
    WAL_SUBDIR,
    RecoveryError,
    RecoveryReport,
    recover_index,
    verify_index,
)
from repro_torch.persist.snapshot import (
    PersistDirConflict,
    load_latest,
    persist_dir_in_use,
    publish,
)
from repro_torch.persist.wal import (
    MutationWAL,
    WALCorruption,
    WALRecord,
    WALUnavailable,
    read_wal,
)

__all__ = [
    "SNAP_SUBDIR",
    "WAL_SUBDIR",
    "PersistDirConflict",
    "RecoveryError",
    "RecoveryReport",
    "recover_index",
    "verify_index",
    "load_latest",
    "persist_dir_in_use",
    "publish",
    "MutationWAL",
    "WALCorruption",
    "WALRecord",
    "WALUnavailable",
    "read_wal",
]
