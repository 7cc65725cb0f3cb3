"""Stream Q(λ): replay-free online control (arXiv 2410.14606).

Port of ``repro/core/stream_q.py``, batched over a fleet of lanes.  The
move space is DQN's (action (i, j) re-assigns executor i to machine j,
|A| = N·M), but a lane holds no replay buffer, no target network and no
Adam state, only:

  * eligibility traces ``z`` shaped like the Q-net (γλ-decayed, cut on a
    non-greedy move: Watkins),
  * a Welford observation normalizer,
  * one pending TD error ``delta`` between observe and update.

``observe`` folds the transition into the traces at once; ``update``
applies the TD step with ObGD.  The Q-net starts from
:func:`networks.sparse_init`.  As in the port's DQN, state is updated in
place, and the ε coin and the random move may be passed in (the epoch's
``EpochDraws.explore_add`` / ``explore_move``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import api
from repro_torch.core import networks as nets
from repro_torch.core.dqn import apply_move
from repro_torch.core.exploration import EpsilonSchedule, epsilon_greedy
from repro_torch.core.streaming import (ObsNorm, norm_apply, norm_init,
                                        norm_update, obgd_step,
                                        reward_norm_update, trace_decay_add,
                                        trace_zeros_like)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class StreamQConfig:
    n_executors: int
    n_machines: int
    state_dim: int
    gamma: float = 0.99
    lam: float = 0.9             # eligibility-trace decay λ
    lr: float = 1.0              # ObGD base stepsize α (self-throttling)
    kappa: float = 3.0           # ObGD overshoot margin
    # the reference's lean (8, 8) net; at fan-in 8 the streaming paper's
    # 0.9 zero fraction leaves 1-2 live weights a unit, so 0.5 here
    sparsity: float = 0.5        # sparse-init zero fraction
    hidden: tuple = (8, 8)
    reward_scale: float = 0.25   # same affine rescale as the replay agents
    eps: EpsilonSchedule = EpsilonSchedule(decay_epochs=300)

    @property
    def num_actions(self) -> int:
        return self.n_executors * self.n_machines


@dataclasses.dataclass
class StreamQState:
    qnet: nets.FleetMLP
    z: list                      # eligibility traces, qnet.parameters() order
    norm: ObsNorm
    delta: torch.Tensor          # [F] pending TD error (consumed by update)
    epoch: torch.Tensor          # [F] int32
    r_mean: torch.Tensor         # [F]
    r_var: torch.Tensor          # [F]
    r_count: torch.Tensor        # [F] int32

    @property
    def fleet(self) -> int:
        return self.epoch.shape[0]


def init_state(gen: torch.Generator | None, cfg: StreamQConfig, fleet: int,
               device: str | torch.device | None = None) -> StreamQState:
    """Fresh lanes on ``device`` (default CUDA; raises without a GPU)."""
    device = resolve_device(device)
    q = nets.sparse_init((cfg.state_dim, *cfg.hidden, cfg.num_actions), fleet,
                         sparsity=cfg.sparsity, gen=gen, device=device)
    return StreamQState(
        qnet=q, z=trace_zeros_like(list(q.parameters())),
        norm=norm_init(cfg.state_dim, fleet, device),
        delta=torch.zeros(fleet, device=device),
        epoch=torch.zeros(fleet, dtype=torch.int32, device=device),
        r_mean=torch.zeros(fleet, device=device),
        r_var=torch.ones(fleet, device=device),
        r_count=torch.zeros(fleet, dtype=torch.int32, device=device),
    )


@torch.no_grad()
def select_move(state: StreamQState, cfg: StreamQConfig, s_vec: torch.Tensor,
                explore: bool = True, add: torch.Tensor | None = None,
                move: torch.Tensor | None = None,
                gen: torch.Generator | None = None):
    """ε-greedy moves ``[F]`` over normalized observations, and whether
    each is greedy (``[F]`` float; feeds the Watkins cut in
    :func:`observe`: a random move that equals argmax Q counts as greedy).
    ``add`` (the ε coin) and ``move`` (the random move) are the draws."""
    q = nets.apply_qnet(state.qnet, norm_apply(state.norm, s_vec))
    best = q.argmax(-1)
    m = epsilon_greedy(q, cfg.eps(state.epoch), add, move, gen) if explore else best
    return m, (m == best).to(torch.float32)


def observe(cfg: StreamQConfig, state: StreamQState, s_vec, aux, reward,
            s_next) -> StreamQState:
    """Fold one transition into the traces and stash the TD error.  Both
    endpoints are normalized under the statistics ``select`` saw; only then
    is ``s_vec`` folded into them (one fold per observation)."""
    move, greedy = aux
    r_std, state.r_mean, state.r_var, state.r_count = reward_norm_update(
        reward, state.r_mean, state.r_var, state.r_count,
        scale=cfg.reward_scale)
    x = norm_apply(state.norm, s_vec)
    x_next = norm_apply(state.norm, s_next)
    params = list(state.qnet.parameters())
    with torch.no_grad():
        q_next = nets.apply_qnet(state.qnet, x_next).max(-1).values
    with torch.enable_grad():
        q_sa = nets.apply_qnet(state.qnet, x).gather(-1, move[:, None])[:, 0]
        grads = torch.autograd.grad(q_sa.sum(), params)
    state.delta = r_std + cfg.gamma * q_next - q_sa.detach()
    # Watkins Q(λ): a non-greedy move cuts the trace before accumulation
    trace_decay_add(state.z, grads, cfg.gamma * cfg.lam * greedy)
    state.norm = norm_update(state.norm, s_vec)
    return state


def update(state: StreamQState, cfg: StreamQConfig) -> StreamQState:
    """Apply the pending ObGD step and consume it (δ = 0 after)."""
    obgd_step(list(state.qnet.parameters()), state.z, state.delta, cfg.lr,
              cfg.kappa)
    state.delta = torch.zeros_like(state.delta)
    return state


def tick(state: StreamQState) -> StreamQState:
    state.epoch = state.epoch + 1
    return state


# --------------------------------------------------------------------------
# The Agent-interface adapter (core/api.py).
# --------------------------------------------------------------------------
def _agent_init(gen, cfg: StreamQConfig, fleet: int, device, env_params=None):
    return init_state(gen, cfg, fleet, device)


def _agent_select(cfg: StreamQConfig, state, s_vec, env_state, env_params,
                  explore, draws, gen):
    add = move = None
    if draws is not None:
        add, move = draws.explore_add, draws.explore_move
    m, greedy = select_move(state, cfg, s_vec, explore=explore, add=add,
                            move=move, gen=gen)
    return apply_move(env_state.X, m, cfg.n_machines), (m, greedy)


def _agent_observe(cfg: StreamQConfig, state, s_vec, aux, reward, s_next):
    return observe(cfg, state, s_vec, aux, reward, s_next)


def _agent_update(cfg: StreamQConfig, state, idx, gen):
    return update(state, cfg)


def _agent_tick(cfg: StreamQConfig, state):
    return tick(state)


def as_agent(cfg: StreamQConfig) -> api.Agent:
    """Stream Q(λ) as a pluggable Agent bundle."""
    return api.Agent(name="stream_q", cfg=cfg, init_fn=_agent_init,
                     select_fn=_agent_select, observe_fn=_agent_observe,
                     update_fn=_agent_update, tick_fn=_agent_tick)


def agent_factory(env, **overrides) -> api.Agent:
    """Registry hook: size a StreamQConfig for ``env`` (or pass ``cfg=``)."""
    cfg = overrides.pop("cfg", None)
    if cfg is None:
        cfg = StreamQConfig(n_executors=env.N, n_machines=env.M,
                            state_dim=env.state_dim, **overrides)
    return as_agent(cfg)


api.register_agent("stream_q", agent_factory)
