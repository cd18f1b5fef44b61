from .sharding import (
    AbstractMesh,
    AxisRules,
    NamedSharding,
    PartitionSpec,
    axis_rules,
    constrain,
    current_rules,
    logical_to_spec,
    make_rules,
    mesh_sizes,
    named_shardings,
)
from .zero import zero_shard_spec, zero_shard_tree

__all__ = [
    "AbstractMesh",
    "AxisRules",
    "NamedSharding",
    "PartitionSpec",
    "axis_rules",
    "constrain",
    "current_rules",
    "logical_to_spec",
    "make_rules",
    "mesh_sizes",
    "named_shardings",
    "zero_shard_spec",
    "zero_shard_tree",
]
