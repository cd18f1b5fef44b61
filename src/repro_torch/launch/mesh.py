"""Production and debug meshes.

The port of ``repro.launch.mesh``.  A production mesh is a single pod of
16×16 = 256 cards (data, model) or two pods, 2×16×16 = 512 cards (pod,
data, model); the `pod` axis is the slowest and carries only data
parallelism and the gradient reduction.  No process holds that many cards,
so :func:`make_production_mesh` returns the mesh's names and sizes alone
(:class:`~repro_torch.distributed.sharding.AbstractMesh`), which is all the
rules and specs read; the dry run traces on a ``DeviceMesh`` of a fake
process group of the mesh's size (:mod:`repro_torch.launch.dryrun`).
:func:`make_debug_mesh` is a real ``DeviceMesh`` over the devices this
process has.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device
from ..distributed.sharding import AbstractMesh, mesh_sizes

__all__ = ["make_production_mesh", "make_debug_mesh", "mesh_axis_sizes"]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_debug_mesh(shape=(1, 1), axes=("data", "model"), *, device=None) -> DeviceMesh:
    """A real mesh over the devices this process has: CUDA unless the caller
    asks for the CPU (``device="cpu"``, or
    :func:`repro_torch.device.set_default_device`).

    With no process group yet, a one-rank group is made over an in-process
    ``HashStore`` (nccl on CUDA, gloo on the CPU) for a one-device mesh; the
    caller ends it with ``torch.distributed.destroy_process_group()``.  A
    larger mesh needs the caller's group, of the mesh's size."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise ValueError(f"a {tuple(shape)} mesh needs a process group of "
                             f"{math.prod(shape)} ranks; initialise it first")
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return mesh_sizes(mesh)
