"""Checkpointing with a manifest, async save, and restore onto a device.

The reference's ``checkpoint.manager`` in PyTorch, with its on-disk layout
and crash contract unchanged, so a checkpoint written by either package
restores in the other:

* ``save`` writes one ``shard_0.npz`` (leaves as ``arr_<i>``, in the
  tree's leaf order) plus a JSON manifest holding (step, tree structure,
  leaf count, time, extras).  Writes go to a temp dir and are atomically
  renamed — a crash mid-save never corrupts the latest checkpoint.
  Re-saving an existing step renames the old dir aside, publishes, then
  deletes it: at no instant is the previous good checkpoint gone while the
  new one is unpublished.  ``async_save`` does the device->host transfer
  synchronously and the file IO on a background thread.
* Trees are dicts, lists, tuples and ``None`` over leaves that are tensors,
  ndarrays or scalars, flattened in jax's leaf order (dict keys sorted).
  The manifest's ``treedef`` is jax's string form of the structure, e.g.
  ``PyTreeDef({'pq': [], 'state': [*, *, *]})``, so manifests of the two
  packages differ only in ``time``.
* ``restore`` rebuilds the tree from a ``like`` template with tensors on
  ``device``.  Leaves are loaded by their explicit ``arr_<i>`` key (never
  ``data.files`` iteration order), and a leaf-count mismatch raises
  :class:`CheckpointCorruption`, not a bare assert.
* ``latest_step`` + retention give crash-loop safety; ``_gc`` also sweeps
  orphaned ``*.tmp`` / ``*.old`` dirs left behind by crashed saves.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch


class CheckpointCorruption(RuntimeError):
    """A checkpoint dir exists but cannot be trusted (missing leaves,
    leaf-count mismatch, unreadable manifest) — named so callers can refuse
    to serve instead of crashing on a bare assert."""


def _flatten(tree: Any, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` in jax's order; returns the
    structure in jax's ``PyTreeDef`` notation (without the wrapper)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "{" + ", ".join(
            f"{k!r}: {_flatten(tree[k], leaves)}" for k in keys
        ) + "}"
    if isinstance(tree, (list, tuple)):
        inner = [_flatten(x, leaves) for x in tree]
        if isinstance(tree, list):
            return "[" + ", ".join(inner) + "]"
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
    leaves.append(tree)
    return "*"


def tree_flatten(tree: Any) -> "tuple[list, str]":
    """``(leaves, treedef)``: the leaves in jax's order and the structure
    as ``str(jax.tree.flatten(tree)[1])`` spells it."""
    leaves: list = []
    spec = _flatten(tree, leaves)
    return leaves, f"PyTreeDef({spec})"


def _unflatten(like: Any, it: Iterator) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}  # the template's key order
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, it) for x in like)
    return next(it)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """The structure of ``like`` with ``leaves`` (jax's order) put in."""
    return _unflatten(like, iter(leaves))


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._sweep_orphans()

    # ------------------------------------------------------------ paths --
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    @staticmethod
    def _is_published(name: str) -> bool:
        return (
            name.startswith("step_")
            and not name.endswith(".tmp")
            and not name.endswith(".old")
        )

    def latest_step(self) -> Optional[int]:
        steps = [
            int(d.split("_")[1])
            for d in os.listdir(self.dir)
            if self._is_published(d)
        ]
        return max(steps) if steps else None

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()  # one async save in flight at a time
        leaves, treedef = tree_flatten(tree)
        host = [_to_host(x) for x in leaves]
        self._write(step, host, treedef, extra or {})

    def async_save(self, step: int, tree: Any, extra: dict | None = None):
        self.wait()
        leaves, treedef = tree_flatten(tree)
        host = [_to_host(x) for x in leaves]  # sync D2H
        ex = dict(extra or {})
        self._pending = threading.Thread(
            target=self._write, args=(step, host, treedef, ex), daemon=True
        )
        self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host: list, treedef: str, extra: dict):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):  # leftover of a crashed save of this step
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard_0.npz"), *host)
        manifest = {
            "step": step,
            "treedef": treedef,
            "n_leaves": len(host),
            "time": time.time(),
            **extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # publish without a window where no good copy of this step exists:
        # the previous copy (if any) is renamed aside — still restorable up
        # to the instant the fresh one lands — and deleted only afterwards
        old = final + ".old"
        if os.path.exists(old):
            if os.path.exists(final):  # superseded leftover
                shutil.rmtree(old)
            else:  # a previous publish died between its two renames
                os.rename(old, final)
        if os.path.exists(final):
            os.rename(final, old)
        os.rename(tmp, final)  # atomic publish
        if os.path.exists(old):
            shutil.rmtree(old)
        self._gc()

    def _sweep_orphans(self):
        """Crash cleanup.  ``*.tmp`` dirs are unfinished writes — delete
        (there is no way to know the write completed).  A ``*.old`` whose
        base step is still published was superseded — delete; one whose
        base is *missing* is the previous good checkpoint caught between
        the two publish renames — restore it instead of leaking (or worse,
        deleting) it."""
        names = os.listdir(self.dir)
        published = {d for d in names if self._is_published(d)}
        for d in names:
            if not d.startswith("step_"):
                continue
            path = os.path.join(self.dir, d)
            if d.endswith(".tmp"):
                shutil.rmtree(path, ignore_errors=True)
            elif d.endswith(".old"):
                base = d.rsplit(".", 1)[0]
                if base in published:
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.rename(path, os.path.join(self.dir, base))

    def _gc(self):
        self._sweep_orphans()
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.dir)
            if self._is_published(d)
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def restore(
        self,
        step: Optional[int] = None,
        like: Any = None,
        shardings: Any = None,
        device=None,
    ):
        """Load a checkpoint.  ``like`` provides the tree structure; the
        leaves come back as tensors on ``device`` (the card unless the
        caller names one).  ``shardings`` (the reference's elastic
        re-shard onto a mesh) waits for DTensor, ROADMAP queue 1 item 11."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...): re-sharding onto a device mesh "
                "needs DTensor, ROADMAP queue 1 item 11"
            )
        # core imports this module (through the runtime): import it here
        from repro_torch.core.ivf import _resolve_device

        device = _resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "shard_0.npz"))
        n = manifest.get("n_leaves")
        if n is None or n != len(data.files):
            raise CheckpointCorruption(
                f"{d}: manifest says {n} leaves, archive holds "
                f"{len(data.files)}"
            )
        # load by explicit index — ``data.files`` iteration order is a zip
        # implementation detail, and trusting it silently permutes leaves
        try:
            host = [data[f"arr_{i}"] for i in range(n)]
        except KeyError as e:
            raise CheckpointCorruption(
                f"{d}: missing leaf {e.args[0]!r} (expected arr_0..arr_{n - 1})"
            ) from e
        if like is None:
            raise ValueError("pass `like` (a tree template)")
        leaves, _ = tree_flatten(like)
        if len(leaves) != len(host):
            raise CheckpointCorruption(
                f"{d}: checkpoint has {len(host)} leaves but the `like` "
                f"template has {len(leaves)} — schema mismatch"
            )
        dev = [_to_tensor(h).to(device) for h in host]
        return tree_unflatten(like, dev), manifest


def _to_tensor(h: np.ndarray) -> torch.Tensor:
    """A host leaf as a CPU tensor, copied only when it is not a writable
    C-ordered array already (0-d arrays keep their shape)."""
    if not (h.flags.c_contiguous and h.flags.writeable):
        h = np.array(h, order="C")
    return torch.from_numpy(h)
