"""Straggler detection + DRL-driven mitigation.

Port of ``repro/fault/straggler.py``.  Detection: per-worker step-time
EWMA; a worker whose smoothed step time exceeds ``threshold`` × the cluster
median is flagged (numpy, as the reference's).

Mitigation: this is exactly the paper's control problem — re-assign work
away from the slow machine.  For MoE models the DRL placement agent
(``core/placement.py``) re-solves expert→device placement with the
straggler's speed factor in the environment; the same DDPG machinery the
paper uses for Storm executors re-schedules experts.  The select takes the
exact k-best set from the host enumeration (``exact_host_knn``), as the
reference's does, so it launches no K-NN kernel."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class StragglerDetector:
    num_workers: int
    alpha: float = 0.2            # EWMA smoothing
    threshold: float = 1.5        # × median => straggler

    def __post_init__(self):
        self.ewma = np.zeros(self.num_workers)
        self.count = np.zeros(self.num_workers, np.int64)

    def observe(self, worker: int, step_time_s: float) -> None:
        if self.count[worker] == 0:
            self.ewma[worker] = step_time_s
        else:
            self.ewma[worker] = (self.alpha * step_time_s
                                 + (1 - self.alpha) * self.ewma[worker])
        self.count[worker] += 1

    def stragglers(self) -> list[int]:
        seen = self.count > 0
        if seen.sum() < max(3, self.num_workers // 2):
            return []
        med = float(np.median(self.ewma[seen]))
        return [w for w in range(self.num_workers)
                if seen[w] and self.ewma[w] > self.threshold * med]

    def speed_factors(self) -> np.ndarray:
        """Relative speed estimate per worker (1.0 = median) — feeds the
        DRL placement environment's ``speed`` vector."""
        seen = self.count > 0
        med = float(np.median(self.ewma[seen])) if seen.any() else 1.0
        f = np.ones(self.num_workers)
        f[seen] = med / np.maximum(self.ewma[seen], 1e-9)
        return f


def mitigate_with_drl(detector: StragglerDetector, placement_env,
                      agent_state, agent_cfg,
                      gen: torch.Generator | None = None) -> torch.Tensor:
    """Re-run the trained DDPG placement agent (a fleet of one) against one
    lane of the environment with the observed speed factors; returns the
    re-assignment, one-hot ``[E, D]`` on the env's device.  ``gen`` stands
    for the reference's key: the greedy select draws nothing from it."""
    from repro_torch.core import ddpg

    if agent_state.fleet != 1:
        raise ValueError(f"mitigate_with_drl takes one agent lane; the state "
                         f"holds {agent_state.fleet}")
    speeds = torch.as_tensor(detector.speed_factors()[: placement_env.M],
                             dtype=torch.float32, device=placement_env.device)
    state = placement_env.reset(1)
    state = state._replace(speed=speeds[None])
    s_vec = placement_env.state_vector(state)
    return ddpg.select_action(agent_state, agent_cfg, s_vec, explore=False,
                              exact_host_knn=True)[0]
