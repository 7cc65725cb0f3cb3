"""Stream AC(λ): replay-free actor-critic online control (arXiv 2410.14606).

Port of ``repro/core/stream_ac.py``, batched over a fleet of lanes.  The
actor is a factorized discrete policy: logits ``[N, M]``, one categorical
per executor row, so an action is always a one-hot assignment (no
projection, no critic argmax).  The critic learns V(s), which
single-transition TD(λ) bootstraps directly.

A lane holds the actor and critic, one trace set per net, the Welford
observation normalizer and one pending TD error; both updates are ObGD
steps, the actor's trace accumulating ∇ log π(a|s) (summed over executor
rows) and the critic's ∇V(s).  Sampling takes ``argmax(g + logits)`` per
row with ``g`` standard Gumbel (what ``jax.random.categorical`` computes),
the draws passed in as ``EpochDraws.explore_gumbel`` or taken from a
generator.  State is updated in place."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import api
from repro_torch.core import networks as nets
from repro_torch.core.streaming import (ObsNorm, gumbel, norm_apply,
                                        norm_init, norm_update, obgd_step,
                                        reward_norm_update, trace_decay_add,
                                        trace_zeros_like)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class StreamACConfig:
    n_executors: int
    n_machines: int
    state_dim: int
    gamma: float = 0.99
    lam: float = 0.9             # eligibility-trace decay λ (both nets)
    lr_actor: float = 1.0        # ObGD base stepsizes (self-throttling)
    lr_critic: float = 1.0
    kappa: float = 2.0           # ObGD overshoot margin
    sparsity: float = 0.9
    hidden: tuple = (8, 8)
    reward_scale: float = 0.25
    # sampling temperature, annealed as the replay agents anneal ε; log π
    # uses the same tempered logits, so updates stay on-policy
    temp_start: float = 1.0
    temp_end: float = 0.02
    temp_decay_epochs: int = 300

    def temperature(self, epoch: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(epoch.to(torch.float32) / self.temp_decay_epochs,
                           0.0, 1.0)
        return self.temp_start + frac * (self.temp_end - self.temp_start)

    @property
    def action_dim(self) -> int:
        return self.n_executors * self.n_machines


@dataclasses.dataclass
class StreamACState:
    actor: nets.FleetMLP         # logits head [N·M]
    critic: nets.FleetMLP        # V(s) head [1]
    z_actor: list                # traces, actor.parameters() order
    z_critic: list
    norm: ObsNorm
    delta: torch.Tensor          # [F] pending TD error (consumed by update)
    epoch: torch.Tensor          # [F] int32
    r_mean: torch.Tensor         # [F]
    r_var: torch.Tensor          # [F]
    r_count: torch.Tensor        # [F] int32

    @property
    def fleet(self) -> int:
        return self.epoch.shape[0]


def init_state(gen: torch.Generator | None, cfg: StreamACConfig, fleet: int,
               device: str | torch.device | None = None) -> StreamACState:
    """Fresh lanes on ``device`` (default CUDA; raises without a GPU)."""
    device = resolve_device(device)
    actor = nets.sparse_init((cfg.state_dim, *cfg.hidden, cfg.action_dim),
                             fleet, sparsity=cfg.sparsity, gen=gen, device=device)
    critic = nets.sparse_init((cfg.state_dim, *cfg.hidden, 1), fleet,
                              sparsity=cfg.sparsity, gen=gen, device=device)
    return StreamACState(
        actor=actor, critic=critic,
        z_actor=trace_zeros_like(list(actor.parameters())),
        z_critic=trace_zeros_like(list(critic.parameters())),
        norm=norm_init(cfg.state_dim, fleet, device),
        delta=torch.zeros(fleet, device=device),
        epoch=torch.zeros(fleet, dtype=torch.int32, device=device),
        r_mean=torch.zeros(fleet, device=device),
        r_var=torch.ones(fleet, device=device),
        r_count=torch.zeros(fleet, dtype=torch.int32, device=device),
    )


def _logits(actor: nets.FleetMLP, cfg: StreamACConfig, x: torch.Tensor,
            temp: torch.Tensor) -> torch.Tensor:
    """``[F, N, M]`` logits at the per-lane temperatures ``temp [F]``."""
    raw = actor(x).reshape(x.shape[0], cfg.n_executors, cfg.n_machines)
    return raw / temp[:, None, None]


@torch.no_grad()
def select_assignment(state: StreamACState, cfg: StreamACConfig,
                      s_vec: torch.Tensor, explore: bool = True,
                      g: torch.Tensor | None = None,
                      gen: torch.Generator | None = None):
    """Sample (or, without ``explore``, take the argmax of) one machine per
    executor row: ``argmax(g + logits)``, ``g [F, N, M]`` standard Gumbel
    (drawn from ``gen`` when not passed).  Returns the one-hot action
    ``[F, N, M]`` and the machines ``[F, N]``."""
    x = norm_apply(state.norm, s_vec)
    logits = _logits(state.actor, cfg, x, cfg.temperature(state.epoch))
    if explore:
        if g is None:
            g = gumbel(logits.shape, gen, logits.device)
        machines = (g + logits).argmax(-1)
    else:
        machines = logits.argmax(-1)
    action = torch.nn.functional.one_hot(machines, cfg.n_machines).to(torch.float32)
    return action, machines


def observe(cfg: StreamACConfig, state: StreamACState, s_vec, aux, reward,
            s_next) -> StreamACState:
    """Fold one transition into both trace sets and stash the TD error."""
    machines = aux
    r_std, state.r_mean, state.r_var, state.r_count = reward_norm_update(
        reward, state.r_mean, state.r_var, state.r_count,
        scale=cfg.reward_scale)
    x = norm_apply(state.norm, s_vec)
    x_next = norm_apply(state.norm, s_next)
    critic_p = list(state.critic.parameters())
    actor_p = list(state.actor.parameters())
    temp = cfg.temperature(state.epoch)
    with torch.enable_grad():
        v = state.critic(x)[:, 0]
        grad_v = torch.autograd.grad(v.sum(), critic_p)
        lp = torch.log_softmax(_logits(state.actor, cfg, x, temp), dim=-1)
        logp = lp.gather(-1, machines[..., None])[..., 0].sum(-1)      # [F]
        grad_pi = torch.autograd.grad(logp.sum(), actor_p)
    with torch.no_grad():
        v_next = state.critic(x_next)[:, 0]
    state.delta = r_std + cfg.gamma * v_next - v.detach()
    decay = cfg.gamma * cfg.lam
    trace_decay_add(state.z_actor, grad_pi, decay)
    trace_decay_add(state.z_critic, grad_v, decay)
    state.norm = norm_update(state.norm, s_vec)
    return state


def update(state: StreamACState, cfg: StreamACConfig) -> StreamACState:
    """Apply both pending ObGD steps, then consume the error (δ = 0 after:
    one TD step per transition)."""
    obgd_step(list(state.critic.parameters()), state.z_critic, state.delta,
              cfg.lr_critic, cfg.kappa)
    obgd_step(list(state.actor.parameters()), state.z_actor, state.delta,
              cfg.lr_actor, cfg.kappa)
    state.delta = torch.zeros_like(state.delta)
    return state


def tick(state: StreamACState) -> StreamACState:
    state.epoch = state.epoch + 1
    return state


# --------------------------------------------------------------------------
# The Agent-interface adapter (core/api.py).
# --------------------------------------------------------------------------
def _agent_init(gen, cfg: StreamACConfig, fleet: int, device, env_params=None):
    return init_state(gen, cfg, fleet, device)


def _agent_select(cfg: StreamACConfig, state, s_vec, env_state, env_params,
                  explore, draws, gen):
    g = None if draws is None else draws.explore_gumbel
    return select_assignment(state, cfg, s_vec, explore=explore, g=g, gen=gen)


def _agent_observe(cfg: StreamACConfig, state, s_vec, aux, reward, s_next):
    return observe(cfg, state, s_vec, aux, reward, s_next)


def _agent_update(cfg: StreamACConfig, state, idx, gen):
    return update(state, cfg)


def _agent_tick(cfg: StreamACConfig, state):
    return tick(state)


def as_agent(cfg: StreamACConfig) -> api.Agent:
    """Stream AC(λ) as a pluggable Agent bundle."""
    return api.Agent(name="stream_ac", cfg=cfg, init_fn=_agent_init,
                     select_fn=_agent_select, observe_fn=_agent_observe,
                     update_fn=_agent_update, tick_fn=_agent_tick)


def agent_factory(env, **overrides) -> api.Agent:
    """Registry hook: size a StreamACConfig for ``env`` (or pass ``cfg=``)."""
    cfg = overrides.pop("cfg", None)
    if cfg is None:
        cfg = StreamACConfig(n_executors=env.N, n_machines=env.M,
                             state_dim=env.state_dim, **overrides)
    return as_agent(cfg)


api.register_agent("stream_ac", agent_factory)
