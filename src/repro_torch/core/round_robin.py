"""Storm's default scheduler: round-robin executor→slot→machine assignment.

Port of ``repro/core/round_robin.py``.  Results in near-even workload
spread with no communication awareness — the paper's "Default" baseline.
Also a trivial non-learning :class:`~repro_torch.core.api.Agent`
(``make_agent("round_robin", env)``) whose state is an ``[F]`` epoch
counter, so the baseline runs through the same fleet runner as the DRL
methods."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.device import resolve_device


def round_robin(n_executors: int, n_machines: int,
                alive: np.ndarray | None = None,
                device: str | torch.device | None = None) -> torch.Tensor:
    """One-hot ``[N, M]`` float32 on ``device`` (default CUDA); skips dead
    machines (``alive [M]`` bool)."""
    machines = np.arange(n_machines)
    if alive is not None:
        machines = machines[np.asarray(alive, dtype=bool)]
    idx = machines[np.arange(n_executors) % len(machines)]
    X = np.zeros((n_executors, n_machines), dtype=np.float32)
    X[np.arange(n_executors), idx] = 1.0
    return torch.as_tensor(X, device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class RoundRobinConfig:
    n_executors: int
    n_machines: int


def _agent_init(gen, cfg: RoundRobinConfig, fleet: int, device,
                env_params=None):
    return torch.zeros(fleet, dtype=torch.int32, device=resolve_device(device))


def _agent_select(cfg: RoundRobinConfig, state, s_vec, env_state, env_params,
                  explore, draws, gen):
    # one assignment per state vector: [F] lanes, or a serving plane's
    # [1, n_slots] rows
    lead = state.shape if s_vec is None else s_vec.shape[:-1]
    idx = torch.arange(cfg.n_executors, device=state.device) % cfg.n_machines
    X = torch.nn.functional.one_hot(idx, cfg.n_machines).to(torch.float32)
    return X.expand(*lead, *X.shape).clone(), torch.zeros(lead, device=state.device)


def _agent_observe(cfg, state, s_vec, aux, reward, s_next):
    return state


def _agent_update(cfg, state, idx, gen):
    return state


def _agent_tick(cfg, state):
    return state + 1


def as_agent(cfg: RoundRobinConfig) -> api.Agent:
    return api.Agent(name="round_robin", cfg=cfg, init_fn=_agent_init,
                     select_fn=_agent_select, observe_fn=_agent_observe,
                     update_fn=_agent_update, tick_fn=_agent_tick)


def agent_factory(env, **overrides) -> api.Agent:
    cfg = overrides.pop("cfg", None)
    if cfg is None:
        cfg = RoundRobinConfig(n_executors=env.N, n_machines=env.M,
                               **overrides)
    return as_agent(cfg)


api.register_agent("round_robin", agent_factory)
