"""Crash-consistent online snapshots of the serving index.

The reference's snapshot module in PyTorch, with its layout, manifest keys
and checks unchanged.  A snapshot is one published checkpoint directory
(via ``checkpoint.manager.CheckpointManager`` — atomic-rename publish,
orphan sweep, retention GC) holding:

* every ``IVFState`` leaf as written by ``core.ivf.state_to_host`` (bf16
  stored as its uint16 bit pattern), plus the PQ codebooks when the index
  is IVFPQ;
* a manifest carrying the **LSN fence** — the WAL LSN of the last mutation
  applied to the captured state — plus ``next_id``, the state-schema
  version, and per-leaf CRC32s.

``step`` in the checkpoint layout *is* the LSN: ``latest_step()`` finds
the most recent snapshot and recovery replays exactly the WAL records
with ``lsn > manifest["lsn"]``.  The capture itself (a copy on the
mutation lane's stream with every writer held out) lives in
``ServingRuntime.snapshot``; this module is the pure publish/load half, so
it is testable without a runtime.

``publish`` checks the ``snapshot_publish`` fault site *before* touching
disk: a crash there must leave the previous snapshot and the whole WAL
intact, which the crash-matrix test asserts.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np

from repro_torch.checkpoint.manager import (
    CheckpointCorruption,
    CheckpointManager,
)
from repro_torch.core import pq as pqmod
from repro_torch.core.faults import NO_FAULTS, FaultPlan
from repro_torch.core.ivf import (
    STATE_SCHEMA_VERSION,
    StateSchemaError,
    _resolve_device,
    state_from_host,
)

log = logging.getLogger(__name__)

#: persist-directory layout (file-format constants: existing deployments
#: have data under these names).  Defined here, not in recovery.py, so
#: core.runtime can import them without touching the recovery module —
#: recovery imports core.ivf, and a module-level runtime->recovery import
#: would close that cycle on `import repro_torch.persist`.
SNAP_SUBDIR = "snapshots"
WAL_SUBDIR = "wal"

class PersistDirConflict(RuntimeError):
    """A *plain* runtime was pointed at a persist directory that already
    holds snapshots or WAL segments.  Constructing over it would stamp
    the old log's LSNs onto a fresh in-memory index — forking the log
    from the state, and silently shadowing the durable history.  Reopen
    through ``ServingRuntime.recover`` (or use an empty directory)."""


def persist_dir_in_use(root: str) -> bool:
    """True when ``root`` already holds snapshot or WAL data.  Any entry
    under either subtree counts — even orphaned temp dirs mean a prior
    writer whose history a fresh runtime would fork."""
    for sub in (SNAP_SUBDIR, WAL_SUBDIR):
        d = os.path.join(root, sub)
        if os.path.isdir(d) and len(os.listdir(d)) > 0:
            return True
    return False


#: manifest key names (file-format constants: renaming any is a format
#: break for every existing snapshot — treat like WAL_VERSION)
MANIFEST_KIND = "ivf_snapshot"
SNAP_KIND_KEY = "kind"
SNAP_LSN_KEY = "lsn"
SNAP_NEXT_ID_KEY = "next_id"
SNAP_STATE_META_KEY = "state_meta"
SNAP_HAS_PQ_KEY = "has_pq"


def _tree(arrays: "dict[str, np.ndarray]", fields: "list[str]",
          pq_books: Optional[np.ndarray]) -> dict:
    """The exact pytree handed to CheckpointManager: field order comes
    from the state meta (not dict iteration), PQ codebooks ride as an
    extra leaf list so flat and PQ indexes differ only in leaf count."""
    return {
        "pq": [] if pq_books is None else [np.asarray(pq_books)],
        "state": [arrays[name] for name in fields],
    }


def publish(
    mgr: CheckpointManager,
    arrays: "dict[str, np.ndarray]",
    state_meta: dict,
    *,
    lsn: int,
    next_id: int,
    pq_books: Optional[np.ndarray] = None,
    faults: Optional[FaultPlan] = None,
) -> int:
    """Write one snapshot (synchronously — the runtime calls this from its
    own background thread).  Returns the published LSN."""
    plan = faults if faults is not None else NO_FAULTS
    plan.check("snapshot_publish")
    fields = list(state_meta["fields"])
    extra = {
        SNAP_KIND_KEY: MANIFEST_KIND,
        SNAP_LSN_KEY: int(lsn),
        SNAP_NEXT_ID_KEY: int(next_id),
        SNAP_STATE_META_KEY: state_meta,
        SNAP_HAS_PQ_KEY: pq_books is not None,
    }
    mgr.save(int(lsn), _tree(arrays, fields, pq_books), extra=extra)
    log.info("published snapshot @ lsn %d (%d leaves)", lsn, len(fields))
    return int(lsn)


def load_latest(directory: str, device=None):
    """Load the newest published snapshot onto ``device`` (the card unless
    the caller names one).

    Returns ``(state, pq, manifest)`` — ``state`` a device-resident,
    CRC-verified ``IVFState``; ``pq`` a :class:`PQParams` or ``None``;
    ``manifest`` the dict carrying the LSN fence.  Raises
    ``FileNotFoundError`` when the directory holds no snapshot, and
    :class:`CheckpointCorruption` / ``StateSchemaError`` /
    ``StateChecksumError`` when it holds one that cannot be trusted.
    """
    device = _resolve_device(device)
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no snapshots in {directory}")
    # peek the manifest first: the `like` template's leaf count depends on
    # whether PQ codebooks were captured
    with open(os.path.join(mgr._step_dir(step), "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get(SNAP_KIND_KEY) != MANIFEST_KIND:
        raise CheckpointCorruption(
            f"{directory}: step {step} is not an index snapshot "
            f"(kind={manifest.get(SNAP_KIND_KEY)!r})"
        )
    meta = manifest.get(SNAP_STATE_META_KEY)
    if not isinstance(meta, dict) or "fields" not in meta:
        raise CheckpointCorruption(
            f"{directory}: snapshot manifest lacks state_meta"
        )
    if meta.get("schema") != STATE_SCHEMA_VERSION:
        raise StateSchemaError(
            f"snapshot schema {meta.get('schema')!r} != this build's "
            f"{STATE_SCHEMA_VERSION}"
        )
    fields = list(meta["fields"])
    has_pq = bool(manifest.get(SNAP_HAS_PQ_KEY))
    placeholder = np.zeros((1,), np.float32)
    like = {
        "pq": [placeholder] if has_pq else [],
        "state": [placeholder] * len(fields),
    }
    # leaves stay on the host: the CRC check reads them there, and
    # state_from_host uploads each once
    tree, _ = mgr.restore(step=step, like=like, device="cpu")
    arrays = {
        name: leaf.numpy() for name, leaf in zip(fields, tree["state"])
    }
    state = state_from_host(arrays, meta, verify=True, device=device)
    pq = None
    if has_pq:
        pq = pqmod.pq_from_host(tree["pq"][0].numpy(), device)
    return state, pq, manifest
