"""Meshes, the abstract inputs and shardings of every cell, and the step
builders (the port of ``repro.launch``); the dry run is
``python -m repro_torch.launch.dryrun``."""

from .mesh import make_debug_mesh, make_production_mesh, mesh_axis_sizes
from .steps import build_cell, build_decode, build_prefill, build_train_step, shard_args

__all__ = [
    "build_cell",
    "build_decode",
    "build_prefill",
    "build_train_step",
    "make_debug_mesh",
    "make_production_mesh",
    "mesh_axis_sizes",
    "shard_args",
]
