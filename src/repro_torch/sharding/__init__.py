"""Sharding: device-free shard geometry, logical-axis rules and optimizer
state specs, and the GPipe pipeline (``sharding.pipeline``; port of
``repro/sharding``)."""
from . import shardspec
from .logical import (
    ShardingContext,
    constrain,
    current,
    default_rules,
    param_specs,
    shard_map,
    shardings_for_tree,
    use_sharding,
)
from .shardspec import P, PartitionSpec, SpecMesh
from .state_shardings import opt_state_specs, shardings_from_specs

__all__ = ["shardspec", "P", "PartitionSpec", "SpecMesh", "ShardingContext", "constrain", "current",
           "default_rules", "param_specs", "shard_map", "shardings_for_tree", "use_sharding", "opt_state_specs",
           "shardings_from_specs"]
