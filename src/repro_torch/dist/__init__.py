"""Distribution substrate: logical-axis sharding rules, their DTensor
placements, and mesh helpers.  The port of ``repro.dist``."""
from repro_torch.dist.mesh_utils import axis_sizes, mesh_size, spec_axes, validate_spec
from repro_torch.dist.sharding import (
    Rules,
    ShardingContext,
    current_context,
    default_rules,
    logical_sharding,
    spec_for,
    spec_to_placements,
    tree_shardings,
    with_logical_constraint,
)

__all__ = [
    "Rules",
    "ShardingContext",
    "axis_sizes",
    "current_context",
    "default_rules",
    "logical_sharding",
    "mesh_size",
    "spec_axes",
    "spec_for",
    "spec_to_placements",
    "tree_shardings",
    "validate_spec",
    "with_logical_constraint",
]
