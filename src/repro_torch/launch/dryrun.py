"""Multi-pod dry run: trace every (arch x shape x mesh) cell as a DTensor
program on fake tensors (the reference's ``repro.launch.dryrun``).

For each cell the step runs once, forward and backward and the optimizer's
update where the cell trains, on DTensors with the cell's placements on a
(16, 16) and a (2, 16, 16) ``DeviceMesh`` over a fake process group of 256
or 512 ranks.  Every tensor is a fake tensor: nothing is allocated and no
collective moves a byte.  DTensor's sharding propagation stands where
GSPMD's stood, and this process plays rank 0 (which holds the largest
shard of an uneven split).

Each record holds the reference's keys, per device:
  compile_s                 -- the trace's seconds
  flops                     -- matmul-class FLOPs of the ops rank 0 runs on
                               its local tensors (``torch.utils.
                               flop_counter``'s formulas: mm, bmm, addmm,
                               baddbmm, convolution, attention)
  bytes_accessed            -- each local op's inputs and outputs, views
                               excluded, with no fusion (an upper bound on
                               what fused kernels move)
  collectives               -- bytes (outputs) and counts of the
                               collectives the program issued, under the
                               reference's kind names
  argument_size_in_bytes    -- the arguments' local shards
  output_size_in_bytes      -- the outputs that are not arguments
  temp_size_in_bytes        -- the peak of live local bytes made during the
                               step, the outputs' storages left out
  generated_code_size_in_bytes -- None (there is no compiled program)
and more: ``fits``, arguments, outputs and temp together within one
card's memory (``CARD_BYTES``); ``traced_argument_bytes``, the local
shards' bytes that each trace made held, and ``reckoned_argument_bytes``,
the same cells' reckoned from the placements alone (the two lists must
agree); where the step runs the mesh's MoE dispatch, ``moe_dispatch``:
the elements of the largest storage it made and of the largest
collective output it issued (the weights' gathers left out), beside
``bound_elems``, the largest buffer of the reference's layout
(``mesh_forms.moe_dispatch_bound``).

LM cells are traced at 1 and 2 layers (``steps.calibration_overrides``).
Flops, bytes, collective bytes and outputs are extrapolated to full
depth as v1 + (v2 - v1)(L - 1); the argument bytes come at full depth
from the placements (not quite linear from 1 layer: Adafactor leaves a
[1, D] stat unfactored).  Temp is extrapolated so only
where the cell trains: there autograd keeps each layer's saved tensors
until the backward.  A serving step (prefill, decode) holds one layer's
tensors and what the previous layer left, whatever the depth, so its
temp is the larger of the two traces'.  A GNN cell with more than one
edge chunk is traced again in one chunk, which gives its flops, bytes and
collective bytes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                    # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b   # one arch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k --multi-pod-only
  ... --out results/dryrun.json --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time
import traceback
import weakref

import torch

from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
from repro_torch.launch.roofline import collective_bytes

CARD_BYTES = 80e9  # H100 SXM5 80GB: device memory (datasheet)

# functional collectives (what DTensor issues) -> the reference's kind names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}


def _tensors(tree) -> list:
    """The tensors in ``tree`` (lists, tuples, dicts).  No recursive
    closure: one would hold the list in a reference cycle, and the tensors
    would outlive the op that made them."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _storage_bytes(tensors, skip=()) -> int:
    seen, total = set(skip), 0
    for t in tensors:
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


@contextlib.contextmanager
def _outside_propagation(counter):
    """DTensor's sharding propagation runs each op once on fake tensors of
    the global shapes to learn the output's metadata; those runs are not
    the program's and are not counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise RuntimeError(f"this torch's ShardingPropagator has no {name}: the "
                           "dry run cannot tell propagation from the program")

    def wrapped(self, *args, **kwargs):
        counter.paused += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            counter.paused -= 1

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts what rank 0 runs on its local tensors: FLOPs, bytes, the
    collectives, and the live bytes of the storages made during the step
    (a storage is live until its last tensor dies)."""

    def __init__(self, known_storages):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.paused = 0
        self.flops = 0
        self.bytes = 0
        self.collectives: list = []  # (kind, output bytes) a collective
        self.events: list = []  # (storage serial, +bytes made / -bytes freed)
        self._serial: dict = {}  # id(storage) -> serial, while it lives
        self._known = {id(s) for s in known_storages}
        # while a scoped form runs (``_dispatch_scope``): the elements of
        # the largest storage it made and of the largest collective output;
        # ``moe``: their maxima over its calls
        self.scope = None
        self.moe = None

    def _track(self, t: torch.Tensor, scoped: bool) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known or key in self._serial:
            return
        serial, n = len(self.events), st.nbytes()
        self._serial[key] = serial
        self.events.append((serial, n))
        if scoped:
            self.scope["buffer_elems"] = max(self.scope["buffer_elems"], n // t.element_size())

        def release(counter=weakref.ref(self)):
            c = counter()
            if c is not None:
                c.events.append((c._serial.pop(key), -n))

        weakref.finalize(st, release)

    def serial(self, t: torch.Tensor):
        """The serial of the storage under ``t`` if the step made it."""
        return self._serial.get(id(_local(t).untyped_storage()))

    def peak(self, skip=frozenset()) -> int:
        """Most bytes live at once among the storages the step made, the
        storages ``skip`` (serials) left out."""
        live = peak = 0
        for serial, n in self.events:
            if serial not in skip:
                live += n
                peak = max(peak, live)
        return peak

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor lower it to local ops first
        out = func(*args, **kwargs)
        if self.paused:
            return out
        ins = [t for t in _tensors((args, kwargs))]
        outs = _tensors(out)
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](*args, **kwargs, out_val=out))
        name = packet.__name__
        # a collective whose input is an argument's storage gathers a weight
        scoped = self.scope is not None and not (name in _COLLECTIVES and any(
            id(t.untyped_storage()) in self._known for t in ins))
        if name in _COLLECTIVES:
            self.collectives.append(
                (_COLLECTIVES[name], sum(t.numel() * t.element_size() for t in outs)))
            if scoped:
                self.scope["collective_elems"] = max(
                    self.scope["collective_elems"], *(t.numel() for t in outs))
        schema = func._schema
        view = bool(schema.returns) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in schema.returns)
        if not view and outs:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._track(t, scoped)
        return out


@contextlib.contextmanager
def _dispatch_scope(counter):
    """While the mesh's MoE dispatch form runs, ``counter`` notes the
    largest storage it makes and the largest collective it issues (in
    elements, the weights' gathers left out) beside the bound of the
    reference's layout (``mesh_forms.moe_dispatch_bound``); the maxima
    over every call land in ``counter.moe``."""
    from repro_torch.launch import mesh_forms
    from repro_torch.models import moe

    form = mesh_forms.FORMS[moe.dispatch]

    def scoped(p, cfg, x, gate, expert, cap, shard):
        counter.scope = {"buffer_elems": 0, "collective_elems": 0,
                         "bound_elems": mesh_forms.moe_dispatch_bound(x, cfg, cap, shard)}
        try:
            return form(p, cfg, x, gate, expert, cap, shard)
        finally:
            seen, counter.scope = counter.scope, None
            counter.moe = {k: max(v, (counter.moe or seen)[k]) for k, v in seen.items()}

    mesh_forms.FORMS[moe.dispatch] = scoped
    try:
        yield
    finally:
        mesh_forms.FORMS[moe.dispatch] = form


def trace_cell(cell) -> dict:
    """Run ``cell.fn`` once on fake DTensors laid out by its shardings;
    returns the per-device counts (the record's measured keys)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import shardings as sh

    leaves, _ = tree_flatten(cell.args)
    shards, _ = tree_flatten(cell.in_shardings)
    device = shards[0].mesh.device_type
    t0 = time.perf_counter()
    with FakeTensorMode():
        fake = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in leaves]
        args = sh.distribute(tree_unflatten(cell.args, fake), cell.in_shardings)
        arg_leaves = _tensors(args)
        arg_storages = [_local(t).untyped_storage() for t in arg_leaves]
        arg_bytes = _storage_bytes(arg_leaves)
        counter = _Counter(arg_storages)
        # storages die by reference count, at a point fixed by the program;
        # the cycle collector would free some at points of its own choosing
        gc.disable()
        try:
            with _outside_propagation(counter), _dispatch_scope(counter), counter:
                out = cell.fn(*args)
        finally:
            gc.enable()
        outs = _tensors(out)
        out_bytes = _storage_bytes(outs, skip={id(s) for s in arg_storages})
        # temp: the peak of what the step made, its outputs left out
        temp = counter.peak(skip={counter.serial(t) for t in outs})
        del out, outs
    seconds = time.perf_counter() - t0
    moe = {"moe_dispatch": counter.moe} if counter.moe else {}
    return {
        **moe,
        "compile_s": round(seconds, 1),
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes),
        "collectives": collective_bytes(counter.collectives),
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": temp,
    }


def _coll_sum(c) -> float:
    return float(sum(c["bytes"].values()))


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def reckoned_argument_bytes(cell) -> int:
    """Per-device argument bytes from the placements alone (no trace)."""
    from repro_torch.launch.shardings import local_nbytes

    leaves, _ = tree_flatten(cell.args)
    shards, _ = tree_flatten(cell.in_shardings)
    return sum(local_nbytes(t, s) for t, s in zip(leaves, shards))


def _extrapolate(v1: float, v2: float, layers: int) -> float:
    """Full depth from the 1- and 2-layer traces, a step of v2 - v1 a
    layer; a quantity the second layer does not raise keeps the larger."""
    return v1 + max(v2 - v1, 0) * (layers - 1)


def run_cell(spec, shape_name: str, mesh) -> dict:
    """Trace one cell on ``mesh`` (+ its calibration variants)."""
    from repro_torch.launch.steps import build_cell, calibration_overrides

    cell = build_cell(spec, shape_name, mesh)
    cals = calibration_overrides(spec, shape_name)
    record = {
        "arch": spec.arch_id,
        "shape": shape_name,
        "kind": cell.kind,
        "mesh": mesh_name(mesh),
        "n_devices": mesh.size(),
        "meta": cell.meta,
    }
    if cals and cals[0][2] == "lm_extrapolate":
        (_, c1, _), (_, c2, _) = cals
        v1 = trace_cell(build_cell(spec, shape_name, mesh, c1))
        v2 = trace_cell(build_cell(spec, shape_name, mesh, c2))
        layers = spec.config.n_layers
        record["compile_s"] = round(v1["compile_s"] + v2["compile_s"], 1)
        for k in ("flops", "bytes_accessed"):
            record[k] = _extrapolate(v1[k], v2[k], layers)
        record["collectives"] = v2["collectives"]
        record["collective_bytes_corrected"] = _extrapolate(
            _coll_sum(v1["collectives"]), _coll_sum(v2["collectives"]), layers)
        record["argument_size_in_bytes"] = reckoned_argument_bytes(cell)
        record["traced_argument_bytes"] = [v["argument_size_in_bytes"] for v in (v1, v2)]
        record["reckoned_argument_bytes"] = [
            reckoned_argument_bytes(build_cell(spec, shape_name, mesh, c)) for c in (c1, c2)]
        record["output_size_in_bytes"] = int(_extrapolate(
            v1["output_size_in_bytes"], v2["output_size_in_bytes"], layers))
        v1t, v2t = v1["temp_size_in_bytes"], v2["temp_size_in_bytes"]
        record["temp_size_in_bytes"] = int(_extrapolate(v1t, v2t, layers)
                                           if cell.meta["backward"] else max(v1t, v2t))
        record["calib"] = {
            "v1_flops": v1["flops"], "v2_flops": v2["flops"],
            "v1_bytes": v1["bytes_accessed"], "v2_bytes": v2["bytes_accessed"],
            "v1_temp": v1t, "v2_temp": v2t,
        }
        record["calibration"] = "lm_extrapolate(L1,L2)"
        moe = [v["moe_dispatch"] for v in (v1, v2) if "moe_dispatch" in v]
        if moe:
            record["moe_dispatch"] = {k: max(m[k] for m in moe) for k in moe[0]}
    else:
        record.update(trace_cell(cell))
        record["traced_argument_bytes"] = [record["argument_size_in_bytes"]]
        record["reckoned_argument_bytes"] = [reckoned_argument_bytes(cell)]
        if cals and cals[0][2] == "gnn_exact":
            _, c1, _ = cals[0]
            v1 = trace_cell(build_cell(spec, shape_name, mesh, c1))
            record["compile_s"] = round(record["compile_s"] + v1["compile_s"], 1)
            for k in ("flops", "bytes_accessed"):
                record[k] = v1[k]
            record["collective_bytes_corrected"] = _coll_sum(v1["collectives"])
            record["calib"] = {"chunked_flops": record["flops"], "onechunk_flops": v1["flops"]}
            record["calibration"] = "gnn_exact(single_chunk)"
    record["generated_code_size_in_bytes"] = None
    record["fits"] = bool(record["argument_size_in_bytes"] + record["output_size_in_bytes"]
                          + record["temp_size_in_bytes"] <= CARD_BYTES)
    return record


def main(argv=None) -> None:
    from repro_torch.configs.base import get_arch, list_archs
    from repro_torch.launch.mesh import fake_process_group, make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    records, failures = [], []
    for multi_pod in meshes:
        with fake_process_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=args.device)
            for arch_id in archs:
                spec = get_arch(arch_id)
                shapes = [args.shape] if args.shape else sorted(spec.shapes)
                for shape_name in shapes:
                    tag = f"{arch_id} x {shape_name} x {mesh_name(mesh)}"
                    try:
                        rec = run_cell(spec, shape_name, mesh)
                        records.append(rec)
                        print(
                            f"[OK]   {tag}: trace {rec['compile_s']}s, "
                            f"args/dev {rec['argument_size_in_bytes']/2**30:.2f} GiB, "
                            f"temp/dev {rec['temp_size_in_bytes']/2**30:.2f} GiB, "
                            f"fits {rec['fits']}, flops {rec['flops']:.3e}",
                            flush=True,
                        )
                    except Exception as e:  # noqa: BLE001 -- report and continue
                        failures.append((tag, repr(e)))
                        print(f"[FAIL] {tag}: {e}", flush=True)
                        traceback.print_exc()

    print(f"\n{len(records)} cells traced, {len(failures)} failed")
    for tag, err in failures:
        print(f"  FAILED: {tag}: {err[:200]}")
    if args.out:
        with open(args.out, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
