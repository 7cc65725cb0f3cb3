# The paper's DRL control loop: the DDPG agent (Algorithm 1), its K-NN
# action projection, the fleet runner, and the expert-placement env.
from repro_torch.core.api import (ENV_FAMILIES, Agent, EpochDraws,
                                  agent_families, agent_names, make_agent,
                                  make_epoch_step, params_are_stacked,
                                  register_agent)
from repro_torch.core.ddpg import (DDPGConfig, DDPGState, OfflineDraws,
                                   init_state as ddpg_init)
from repro_torch.core.agent import (History, greedy_assignment_ddpg,
                                    run_online_agent, run_online_fleet)
from repro_torch.core.graph_policy import graph_param_specs
from repro_torch.core.knn_projection import (distance_to, knn_actions,
                                             knn_actions_exact,
                                             knn_assignments_exact,
                                             nearest_assignment)
from repro_torch.core.placement import (ExpertPlacementEnv, PlacementParams,
                                        jamba_placement_env)

__all__ = [
    "ENV_FAMILIES", "Agent", "EpochDraws", "agent_families", "agent_names",
    "make_agent", "make_epoch_step", "params_are_stacked", "register_agent",
    "DDPGConfig", "DDPGState", "OfflineDraws", "ddpg_init", "History",
    "greedy_assignment_ddpg", "run_online_agent", "run_online_fleet",
    "graph_param_specs", "distance_to",
    "knn_actions", "knn_actions_exact", "knn_assignments_exact", "nearest_assignment",
    "ExpertPlacementEnv", "PlacementParams", "jamba_placement_env",
]
