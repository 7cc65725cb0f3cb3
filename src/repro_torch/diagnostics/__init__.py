# Runtime guards for the fleet loops: the device-sync guard over the steady
# state and the chunk-boundary non-finite sweep (port of repro.diagnostics,
# without CompileCounter: no path of the port compiles).
from repro_torch.diagnostics.guards import (GuardState, NonFiniteError, active,
                                            guards, lifted, maybe_check_finite,
                                            steady)

__all__ = ["GuardState", "NonFiniteError", "active", "guards", "lifted",
           "maybe_check_finite", "steady"]
