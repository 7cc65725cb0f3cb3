"""Physical cluster model (numpy copy of ``repro/dsdps/cluster.py``).

The paper's testbed: 10 worker machines, quad-core, 10 slots each, 1 Gbps
network, with per-machine speed multipliers for heterogeneity and
stragglers."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    num_machines: int = 10
    cores_per_machine: int = 4
    slots_per_machine: int = 10
    nic_gbps: float = 1.0
    # fixed per-hop network latency (propagation + batching, ms)
    net_base_ms: float = 0.30
    # intra-machine (same-process) handoff cost (ms)
    local_base_ms: float = 0.01
    # intra-machine inter-process (localhost socket) latency (ms)
    ipc_base_ms: float = 0.06
    # CPU cost of serializing/deserializing one cross-process tuple
    ser_base_ms: float = 0.06
    ser_ms_per_kb: float = 0.08
    # fixed CPU burn per running worker process, in cores
    proc_overhead_cores: float = 0.09
    # effective service inflation per extra distinct co-located component
    mix_penalty: float = 0.05
    # effective CPU speed multipliers per machine
    speeds: tuple[float, ...] = (1.0, 0.92, 0.86, 1.0, 0.78, 0.97,
                                 0.83, 0.95, 0.74, 1.0)

    @property
    def nic_bytes_per_ms(self) -> float:
        return self.nic_gbps * 1e9 / 8.0 / 1e3

    def speed_factors(self, straggler: dict[int, float] | None = None) -> np.ndarray:
        """CPU speed multiplier per machine (<1 = slow)."""
        f = np.asarray(self.speeds, dtype=np.float64)[: self.num_machines].copy()
        if f.shape[0] < self.num_machines:
            f = np.resize(f, self.num_machines)
        if straggler:
            for m, s in straggler.items():
                f[m] = s
        return f


PAPER_CLUSTER = ClusterSpec()
