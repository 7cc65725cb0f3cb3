from repro_torch.dsdps.topology import Component, Edge, GraphObs, Topology
from repro_torch.dsdps.cluster import ClusterSpec, PAPER_CLUSTER
from repro_torch.dsdps.simulator import (EnvParams, SimParams,
                                         average_tuple_time_from_params,
                                         average_tuple_time_ms,
                                         build_sim_params,
                                         lane_params,
                                         measured_latency_from_params,
                                         measured_latency_ms,
                                         params_in_axes, params_stacked,
                                         perturb_rates, perturb_service,
                                         scale_rates, stack_env_params,
                                         to_env_params, with_noise_sigma,
                                         with_speed, with_straggler)
from repro_torch.dsdps.workload import (NEVER_SHIFT, WorkloadProcess, constant,
                                        step_rates)
from repro_torch.dsdps.env import EnvState, SchedulingEnv, StepOut
from repro_torch.dsdps.structural import (Envelope, GraphEnvParams,
                                          StructuralSchedulingEnv,
                                          graph_latency_ms,
                                          measured_graph_latency_ms)
from repro_torch.dsdps import apps, scenarios

__all__ = [
    "Component", "Edge", "GraphObs", "Topology", "ClusterSpec", "PAPER_CLUSTER",
    "SimParams", "EnvParams", "average_tuple_time_ms",
    "average_tuple_time_from_params", "build_sim_params",
    "measured_latency_from_params", "measured_latency_ms", "to_env_params", "scale_rates",
    "with_noise_sigma", "with_speed", "with_straggler", "perturb_service",
    "perturb_rates", "stack_env_params", "params_in_axes", "params_stacked",
    "lane_params", "NEVER_SHIFT", "WorkloadProcess", "constant", "step_rates",
    "EnvState", "SchedulingEnv", "StepOut", "Envelope", "GraphEnvParams",
    "StructuralSchedulingEnv", "graph_latency_ms",
    "measured_graph_latency_ms", "apps", "scenarios",
]
