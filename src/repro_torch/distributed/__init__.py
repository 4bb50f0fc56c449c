"""Meshes of ranks for the port: sharding rules and placements, the
active mesh and the collectives (DESIGN.md §8). Attention runs on each
rank's (batch, kv-head) block by construction (``sharding.py``)."""
from .sharding import (
    DEFAULT_RULES,
    ShardingRules,
    attention_partition,
    attention_pspec,
    batch_pspec,
    logical_to_pspec,
    param_placements,
    shard_params,
)

__all__ = ["DEFAULT_RULES", "ShardingRules", "attention_partition",
           "attention_pspec", "batch_pspec", "logical_to_pspec",
           "param_placements", "shard_params"]
