# Fault handling: heartbeat failure detection, straggler detection and its
# DRL mitigation.  The elastic restart waits for the multi-device port.
from repro_torch.fault.heartbeat import HeartbeatMonitor
from repro_torch.fault.straggler import StragglerDetector, mitigate_with_drl

__all__ = ["HeartbeatMonitor", "StragglerDetector", "mitigate_with_drl"]
