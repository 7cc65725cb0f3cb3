# Fleet-axis sharding: a scenario fleet's lanes cut over a mesh of slots.
from repro_torch.sharding.fleet import (REPLICATE, SHARD, Block, FleetBlocks,
                                        compaction_size, fleet_axes, fleet_host,
                                        fleet_host_tree, fleet_shardings,
                                        fleet_size, is_spanning,
                                        params_partition_specs, shard_fleet)

__all__ = [
    "REPLICATE", "SHARD", "Block", "FleetBlocks", "compaction_size",
    "fleet_axes", "fleet_host", "fleet_host_tree", "fleet_shardings",
    "fleet_size", "is_spanning", "params_partition_specs", "shard_fleet",
]
