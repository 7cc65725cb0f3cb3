# Fault handling: heartbeat failure detection, straggler detection and its
# DRL mitigation, and the elastic re-mesh and restore after a failure.
from repro_torch.fault.elastic import MeshPlan, plan_mesh, resume_after_failure
from repro_torch.fault.heartbeat import HeartbeatMonitor
from repro_torch.fault.straggler import StragglerDetector, mitigate_with_drl

__all__ = ["HeartbeatMonitor", "MeshPlan", "StragglerDetector", "mitigate_with_drl",
           "plan_mesh", "resume_after_failure"]
