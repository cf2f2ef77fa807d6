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
* A bf16 leaf is written as the reference writes a bf16 ``jax.Array``
  (ml_dtypes' npy descr ``<V2``, the raw bits), and read back as bf16
  where the ``like`` leaf is a bf16 tensor, from ``<V2`` or ``uint16``
  bits; a shape or dtype that does not fit raises
  :class:`CheckpointCorruption` (the reference cannot restore its own bf16
  leaves: ``jnp`` refuses ``<V2``).
* ``restore`` rebuilds the tree from a ``like`` template with tensors on
  ``device``, or with ``shardings`` as DTensors on a device mesh (elastic
  restore: each rank keeps its own slice).  Leaves are loaded by their explicit ``arr_<i>`` key (never
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
import zipfile
from typing import Any, Iterator, Optional

import numpy as np
import torch

#: manifest.json key names (file-format constants, as persist.snapshot's:
#: renaming one breaks every checkpoint written before)
MANIFEST_STEP_KEY = "step"
MANIFEST_TREEDEF_KEY = "treedef"
MANIFEST_N_LEAVES_KEY = "n_leaves"
MANIFEST_TIME_KEY = "time"


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


#: a bf16 leaf on the host: its bits as 2-byte voids, the dtype numpy
#: gives the npy descr that ml_dtypes' bfloat16 writes (BF16_DESCR)
BF16_HOST = np.dtype("V2")
BF16_DESCR = "<V2"


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # numpy has no bf16: keep the bits
            return x.view(torch.int16).numpy().view(BF16_HOST)
        return x.numpy()
    return np.asarray(x)


def _savez(path: str, host: list) -> None:
    """``np.savez(path, *host)``, member for member, except that a bf16
    leaf (``BF16_HOST``) gets the ``BF16_DESCR`` header, as the
    reference's bf16 leaves do; numpy would write ``|V2``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, val in enumerate(host):
            val = np.asanyarray(val)
            with zf.open(f"arr_{i}.npy", "w", force_zip64=True) as fid:
                if val.dtype != BF16_HOST:
                    np.lib.format.write_array(fid, val, allow_pickle=True)
                    continue
                np.lib.format.write_array_header_1_0(fid, {
                    "descr": BF16_DESCR, "fortran_order": False,
                    "shape": val.shape})
                bits = np.ascontiguousarray(val).view(np.uint16)
                for chunk in np.nditer(
                        bits, flags=["external_loop", "buffered", "zerosize_ok"],
                        buffersize=8 << 20, order="C"):
                    fid.write(chunk.tobytes("C"))


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
        _savez(os.path.join(tmp, "shard_0.npz"), host)
        manifest = {
            MANIFEST_STEP_KEY: step,
            MANIFEST_TREEDEF_KEY: treedef,
            MANIFEST_N_LEAVES_KEY: len(host),
            MANIFEST_TIME_KEY: time.time(),
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
        caller names one).  ``shardings`` (a tree like ``like`` whose leaves
        are ``launch.shardings.NamedSharding``: a mesh and its placements)
        re-shards onto the current mesh -- elastic restore: each leaf
        becomes a DTensor of which every rank keeps its own slice, with no
        communication, as ``jax.device_put(h, s)`` does; ``device`` is then
        each sharding's mesh."""
        # core imports this module (through the runtime): import it here
        from repro_torch.core.ivf import _resolve_device

        if shardings is None:
            device = _resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "shard_0.npz"))
        n = manifest.get(MANIFEST_N_LEAVES_KEY)
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
        if shardings is None:
            dev = [_leaf(h, t, f"{d}: leaf {i}").to(device)
                   for i, (h, t) in enumerate(zip(host, leaves))]
            return tree_unflatten(like, dev), manifest
        from torch.distributed.tensor import distribute_tensor

        sleaves, sdef = tree_flatten(shardings)
        if sdef != tree_flatten(like)[1]:
            raise CheckpointCorruption(
                f"{d}: the shardings tree {sdef} does not match the `like` "
                f"template's {tree_flatten(like)[1]}")
        dev = [distribute_tensor(_leaf(h, t, f"{d}: leaf {i}"), s.mesh, s.placements,
                                 src_data_rank=None)
               for i, (h, t, s) in enumerate(zip(host, leaves, sleaves))]
        return tree_unflatten(like, dev), manifest


def _leaf(h: np.ndarray, like, where: str) -> torch.Tensor:
    """A host leaf as a CPU tensor.  Where the template's leaf is a bf16
    tensor, the leaf must be bf16 bits (``<V2``, or ``uint16``) of the
    template's shape; a bf16 leaf must meet a bf16 template.  Anything
    else raises rather than cast or reshape in silence."""
    bf16_like = isinstance(like, torch.Tensor) and like.dtype == torch.bfloat16
    if bf16_like:
        if h.dtype not in (BF16_HOST, np.dtype(np.uint16)):
            raise CheckpointCorruption(
                f"{where}: the template's leaf is bfloat16, the checkpoint's "
                f"{h.dtype}")
        if tuple(h.shape) != tuple(like.shape):
            raise CheckpointCorruption(
                f"{where}: shape {tuple(h.shape)}, the template's "
                f"{tuple(like.shape)}")
        return _to_tensor(h.view(np.int16)).view(torch.bfloat16)
    if h.dtype == BF16_HOST:
        raise CheckpointCorruption(
            f"{where}: a bfloat16 leaf, but the template's leaf is "
            f"{getattr(like, 'dtype', type(like).__name__)}")
    return _to_tensor(h)


def _to_tensor(h: np.ndarray) -> torch.Tensor:
    """A host leaf as a CPU tensor, copied only when it is not a writable
    C-ordered array already (0-d arrays keep their shape)."""
    if not (h.flags.c_contiguous and h.flags.writeable):
        h = np.array(h, order="C")
    return torch.from_numpy(h)
