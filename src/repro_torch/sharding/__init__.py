# Sharding: a scenario fleet's lanes cut over a mesh of slots (fleet.py), and
# the LM's name-rule policy (policy.py) and activation context (ctx.py).  The
# fleet's names load on first use, so the models can import ctx without
# pulling in the checkpoint modules the fleet builds on.
import importlib

_FLEET = ("REPLICATE", "SHARD", "Block", "FleetBlocks", "compaction_size",
          "fleet_axes", "fleet_host", "fleet_host_tree", "fleet_shardings",
          "fleet_size", "is_spanning", "params_partition_specs", "shard_fleet")

__all__ = [*_FLEET, "MeshAxes", "PartitionSpec", "ShardingPolicy"]


def __getattr__(name):
    if name in _FLEET:
        return getattr(importlib.import_module("repro_torch.sharding.fleet"), name)
    if name in ("MeshAxes", "PartitionSpec", "ShardingPolicy"):
        return getattr(importlib.import_module("repro_torch.sharding.policy"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
