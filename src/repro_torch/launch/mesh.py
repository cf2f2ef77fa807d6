"""Production mesh construction (the reference's ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices; "pod" is an outer
data axis.

The shapes and axis names are the reference's, so every logical spec of
``launch/shardings.py`` maps one to one.  On H100s: an HGX node holds 8
GPUs joined all to all by NVLink, so the 16-wide "model" axis spans two
nodes, and the "data" and "pod" axes cross InfiniBand (one NIC per GPU).

A ``DeviceMesh`` needs a default process group of the mesh's world size.
A real launcher initialises it (NCCL, one process per GPU); the dry run
(``launch/dryrun.py``) initialises a fake one with ``fake_process_group``,
on which DTensor programs run on fake tensors and no collective moves a
byte.  The mesh is made by a function, so importing this module touches no
process group.
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_mesh(shape: tuple, axes: tuple, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, whose world size must be the mesh's size."""
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of world size {need}; none "
            "is initialised (a launcher calls init_process_group, the dry run "
            "uses launch.mesh.fake_process_group)")
    have = dist.get_world_size()
    if have != need:
        raise RuntimeError(
            f"a {shape} mesh ({' x '.join(axes)}) needs world size {need}, "
            f"the process group has {have}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, device_type)


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch (data parallel), pod-outer."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def n_devices(mesh) -> int:
    return mesh.size()


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """A fake default process group of ``world_size`` ranks (this process
    is ``rank``): collectives return at once and move nothing.  Destroyed
    on exit; only one default group can exist in a process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", world_size=world_size, rank=rank,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()
