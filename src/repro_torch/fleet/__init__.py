# Elastic lane lifecycle for scenario fleets: per-lane early stopping,
# between-chunk lane compaction, and successive-halving scenario search.
from repro_torch.fleet.lifecycle import (ElasticResult, Leaderboard,
                                         ScenarioEntry, StopRule, compact_lanes,
                                         plateau_converged, restore_elastic,
                                         run_online_fleet_elastic,
                                         search_scenarios, take_lanes)

__all__ = [
    "ElasticResult", "Leaderboard", "ScenarioEntry", "StopRule",
    "compact_lanes", "plateau_converged", "restore_elastic",
    "run_online_fleet_elastic", "search_scenarios", "take_lanes",
]
