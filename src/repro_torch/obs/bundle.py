"""Debug bundles: one JSON file with everything a post-mortem needs.

Written on the three paths where the process state is about to become
unavailable or untrustworthy — ``RecoveryError`` (the node refused to
serve), lane death (a worker exhausted its restart budget), and clean
shutdown — into ``<dir>/debug/``.  The subdirectory is a sibling of the
persist layer's ``snapshots/`` and ``wal/`` trees, which
``persist_dir_in_use`` / recovery never scan, so bundles can safely
land inside a persist directory.

Contents: reason, wall-clock time, runtime config, the full stats
snapshot, the flight-recorder window, the trace-ring window, the dispatch
records its traces link to, and any path-specific extras (e.g. the
chained recovery error).  Writes are
atomic (tmp + rename) and best-effort: a failing bundle dump must never
mask the shutdown or the original error, so callers wrap this in
try/except and log.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from repro_torch.obs.trace import dispatches

BUNDLE_SUBDIR = "debug"

_counter = [0]  # disambiguates bundles written within the same ms


def _jsonable(obj):
    """JSON fallback: numpy scalars -> python numbers, else repr."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return repr(obj)


def write_debug_bundle(
    directory: str,
    *,
    reason: str,
    config: Optional[dict] = None,
    stats: Optional[dict] = None,
    events=(),
    traces=(),
    extra: Optional[dict] = None,
) -> str:
    """Write one bundle under ``directory/debug/``; returns the path."""
    traces = list(traces)
    out_dir = os.path.join(directory, BUNDLE_SUBDIR)
    os.makedirs(out_dir, exist_ok=True)
    _counter[0] += 1
    slug = "".join(c if c.isalnum() else "-" for c in reason)[:64]
    name = f"bundle-{slug}-{int(time.time() * 1e3)}-{_counter[0]}.json"
    payload = {
        "reason": reason,
        "written_unix_s": time.time(),
        "pid": os.getpid(),
        "config": config or {},
        "stats": stats or {},
        "events": [e.as_dict() for e in events],
        "traces": [t.as_dict() for t in traces],
        "dispatches": [d.as_dict() for d in dispatches(traces)],
        "extra": extra or {},
    }
    path = os.path.join(out_dir, name)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, default=_jsonable)
        f.write("\n")
    os.replace(tmp, path)
    return path
