"""DQN-based DRL baseline (paper §3.2, shown to underperform at scale).

Port of ``repro/core/dqn.py``, batched over a fleet of lanes.  The action
space is restricted to single-executor moves: action (i, j) re-assigns
executor i to machine j, giving |A| = N·M.  Q(s, ·) is a single MLP head
over all moves; ε-greedy exploration; replay + target network as in Mnih
et al.

As in the port's DDPG, state is updated in place and the random draws (the
ε coin, the random move, replay indices) may be passed in.  Unlike DDPG's,
the reference's DQN ``update_step`` keeps the running reward statistics,
and so does this port."""
from __future__ import annotations

import copy
import dataclasses

import torch

from repro_torch.core import api
from repro_torch.core import networks as nets
from repro_torch.core.exploration import EpsilonSchedule, epsilon_greedy
from repro_torch.core.replay import (Replay, replay_add, replay_init,
                                     replay_sample, sample_indices)
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamState, adam, apply_updates


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    n_executors: int
    n_machines: int
    state_dim: int
    gamma: float = 0.99
    tau: float = 0.01
    batch: int = 32
    buffer: int = 1000
    lr: float = 1e-3
    reward_scale: float = 0.25
    eps: EpsilonSchedule = EpsilonSchedule()

    @property
    def num_actions(self) -> int:
        return self.n_executors * self.n_machines


@dataclasses.dataclass
class DQNState:
    qnet: nets.FleetMLP
    target: nets.FleetMLP            # a copy, never an alias of qnet
    opt: AdamState
    replay: Replay                   # actions [F, cap, 1]: the move index
    epoch: torch.Tensor              # [F] int32
    r_mean: torch.Tensor             # [F]
    r_var: torch.Tensor              # [F]
    r_count: torch.Tensor            # [F] int32

    @property
    def fleet(self) -> int:
        return self.epoch.shape[0]


def init_state(gen: torch.Generator | None, cfg: DQNConfig, fleet: int,
               device: str | torch.device | None = None) -> DQNState:
    """Fresh lanes on ``device`` (default CUDA; raises without a GPU)."""
    device = resolve_device(device)
    q = nets.init_qnet(cfg.state_dim, cfg.num_actions, fleet, gen, device)
    return DQNState(
        qnet=q,
        target=copy.deepcopy(q).requires_grad_(False),
        opt=adam(cfg.lr).init(list(q.parameters())),
        replay=replay_init(fleet, cfg.buffer, cfg.state_dim, 1, device),
        epoch=torch.zeros(fleet, dtype=torch.int32, device=device),
        r_mean=torch.zeros(fleet, device=device),
        r_var=torch.ones(fleet, device=device),
        r_count=torch.zeros(fleet, dtype=torch.int32, device=device),
    )


def apply_move(X: torch.Tensor, move: torch.Tensor,
               n_machines: int) -> torch.Tensor:
    """Lane f moves executor ``move[f] // M`` to machine ``move[f] % M`` in
    ``X [F, N, M]`` (a new tensor)."""
    lanes = torch.arange(X.shape[0], device=X.device)
    X = X.clone()
    X[lanes, move // n_machines] = torch.nn.functional.one_hot(
        move % n_machines, n_machines).to(X.dtype)
    return X


@torch.no_grad()
def select_move(state: DQNState, cfg: DQNConfig, s_vec: torch.Tensor,
                explore: bool = True, add: torch.Tensor | None = None,
                move: torch.Tensor | None = None,
                gen: torch.Generator | None = None) -> torch.Tensor:
    """ε-greedy move ``[F]`` for states ``s_vec [F, S]``; ``add`` (the ε coin)
    and ``move`` (the random move) are the draws, ignored without
    ``explore``."""
    q = nets.apply_qnet(state.qnet, s_vec)
    if not explore:
        return q.argmax(-1)
    return epsilon_greedy(q, cfg.eps(state.epoch), add, move, gen)


def update_step(state: DQNState, cfg: DQNConfig,
                idx: torch.Tensor | None = None,
                gen: torch.Generator | None = None):
    """One Q-learning step on every lane from the replay rows ``idx [F, B]``
    (drawn from ``gen`` when not passed; float uniforms are scaled to each
    lane's filled rows, ``replay.sample_indices``): MSE against r + γ·max Q_target,
    Adam, then the soft target update.  The reward statistics stay.
    Returns (state, ``{"loss": [F]}``)."""
    if idx is None or idx.is_floating_point():   # draw_epoch's uniforms
        idx = sample_indices(state.replay, cfg.batch, gen, u=idx)
    s, a, r, s_next = replay_sample(state.replay, idx)
    a = a[..., 0].long()
    with torch.no_grad():
        y = r + cfg.gamma * nets.apply_qnet(state.target, s_next).max(-1).values
    params = list(state.qnet.parameters())
    q_sa = nets.apply_qnet(state.qnet, s).gather(-1, a[..., None])[..., 0]
    loss = torch.square(y - q_sa).mean(-1)                        # [F]
    grads = torch.autograd.grad(loss.sum(), params)
    upd, state.opt = adam(cfg.lr).update(grads, state.opt, params)
    apply_updates(params, upd)
    nets.soft_update(state.target, state.qnet, cfg.tau)
    return state, {"loss": loss.detach()}


@torch.no_grad()
def store(state: DQNState, s, move, r, s_next,
          reward_scale: float = 1.0) -> DQNState:
    """Standardize reward ``r [F]`` with the running statistics and append
    (s, move, r, s') to each lane's buffer."""
    r = r * reward_scale
    cnt = state.r_count + 1
    alpha = torch.clamp(1.0 / cnt.to(torch.float32), min=0.02)
    mean = state.r_mean + alpha * (r - state.r_mean)
    var = (1 - alpha) * state.r_var + alpha * torch.square(r - mean)
    r_std = torch.clamp((r - mean) / torch.clamp(torch.sqrt(var), min=1e-4),
                        -10, 10)
    replay_add(state.replay, s, move.to(torch.float32)[:, None], r_std, s_next)
    state.r_mean, state.r_var, state.r_count = mean, var, cnt
    return state


def tick(state: DQNState) -> DQNState:
    state.epoch = state.epoch + 1
    return state


# --------------------------------------------------------------------------
# The Agent-interface adapter (core/api.py).
# --------------------------------------------------------------------------
def _agent_init(gen, cfg: DQNConfig, fleet: int, device, env_params=None):
    return init_state(gen, cfg, fleet, device)


def _agent_select(cfg: DQNConfig, state, s_vec, env_state, env_params,
                  explore, draws, gen):
    add = move = None
    if draws is not None:
        add, move = draws.explore_add, draws.explore_move
    m = select_move(state, cfg, s_vec, explore=explore, add=add, move=move,
                    gen=gen)
    return apply_move(env_state.X, m, cfg.n_machines), m


def _agent_observe(cfg: DQNConfig, state, s_vec, aux, reward, s_next):
    return store(state, s_vec, aux, reward, s_next,
                 reward_scale=cfg.reward_scale)


def _agent_update(cfg: DQNConfig, state, idx, gen):
    state, _ = update_step(state, cfg, idx=idx, gen=gen)
    return state


def _agent_tick(cfg: DQNConfig, state):
    return tick(state)


def as_agent(cfg: DQNConfig) -> api.Agent:
    """The DQN baseline as a pluggable Agent bundle."""
    return api.Agent(name="dqn", cfg=cfg, init_fn=_agent_init,
                     select_fn=_agent_select, observe_fn=_agent_observe,
                     update_fn=_agent_update, tick_fn=_agent_tick)


def agent_factory(env, **overrides) -> api.Agent:
    """Registry hook: size a DQNConfig for ``env`` (or pass ``cfg=``)."""
    cfg = overrides.pop("cfg", None)
    if cfg is None:
        cfg = DQNConfig(n_executors=env.N, n_machines=env.M,
                        state_dim=env.state_dim, **overrides)
    return as_agent(cfg)


api.register_agent("dqn", agent_factory)


def init_fleet(gen: torch.Generator | None, cfg: DQNConfig, fleet: int,
               device: str | torch.device | None = None) -> DQNState:
    """Independently-initialized lanes stacked on ``[fleet]``."""
    return init_state(gen, cfg, fleet, device)
