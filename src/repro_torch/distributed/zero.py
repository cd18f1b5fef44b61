"""ZeRO-1: shard optimizer state over the data axis on top of TP sharding.

The port of ``repro.distributed.zero``.  For each parameter's
PartitionSpec the `data` axis goes to the first dimension that is (a) not
already sharded and (b) divisible by the data-axis size, or composes with
the axis already on a dimension that divides by both.  The specs are pure
arithmetic over the mesh's axis names and sizes; a restore or a
``DTensor`` then places master/m/v on 1/data_size of the elements per rank.
"""

from __future__ import annotations

from ..tree import tree_map
from .sharding import PartitionSpec as P
from .sharding import mesh_sizes

__all__ = ["zero_shard_spec", "zero_shard_tree"]


def zero_shard_spec(spec: P, shape: tuple[int, ...], mesh, axis: str = "data") -> P:
    sizes = mesh_sizes(mesh)
    if axis not in sizes:
        return spec
    axis_size = sizes[axis]
    if axis_size == 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and dim % axis_size == 0 and dim >= axis_size:
            parts[i] = axis
            return P(*parts)
        if cur is not None and not isinstance(cur, tuple) and cur != axis:
            # try composing with the existing axis on this dim
            if dim % (sizes[cur] * axis_size) == 0:
                parts[i] = (cur, axis)
                return P(*parts)
    return spec


def zero_shard_tree(spec_tree, shape_tree, mesh, axis: str = "data"):
    """``zero_shard_spec`` over a spec tree and a tree of tensors (or
    anything with ``.shape``) of the same structure."""
    return tree_map(
        lambda s, shp: zero_shard_spec(s, tuple(shp.shape), mesh, axis),
        spec_tree,
        shape_tree,
        is_leaf=lambda v: isinstance(v, P),
    )
