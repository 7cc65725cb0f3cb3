# Atomic, integrity-checked, asynchronous checkpoints, and the fleet
# runner's checkpoint policy (run_online_fleet(checkpoint=...)).
from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer, Checkpointer,
                                                 named_leaves)
from repro_torch.checkpoint.fleet import FleetCheckpoint

__all__ = ["AsyncCheckpointer", "Checkpointer", "FleetCheckpoint", "named_leaves"]
