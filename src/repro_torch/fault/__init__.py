# Fault handling: straggler detection and its DRL mitigation.  The heartbeat
# monitor and the elastic restart wait for the multi-device port.
from repro_torch.fault.straggler import StragglerDetector, mitigate_with_drl

__all__ = ["StragglerDetector", "mitigate_with_drl"]
