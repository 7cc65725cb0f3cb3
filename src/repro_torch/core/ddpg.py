"""Algorithm 1 — the actor-critic-based method for scheduling (paper §3.2.1).

Port of ``repro/core/ddpg.py``, batched over a fleet of lanes: every
state leaf carries the fleet axis ``[F]`` and one call steps all lanes.
Hyper-parameters are the paper's: 2×(64,32,tanh) nets, τ=0.01, γ=0.99,
|B|=1000, H=32, ε-decayed uniform exploration noise, random offline
samples before online learning.  The MIQP-NN optimizer is the K-NN
projection (core/knn_projection.py), whose top-2/regret reduction runs
through the hand-written kernel on CUDA.

The port updates state in place — nets, Adam moments, replay buffer and
statistics — and returns the same object.  Like the reference, every
``update_step`` resets the running reward statistics.  Random draws (exploration,
replay indices, offline transitions) may be passed in; the ones not passed
come from a ``torch.Generator``."""
from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core import networks as nets
from repro_torch.core.exploration import EpsilonSchedule, perturb_proto
from repro_torch.core.knn_projection import knn_actions, knn_actions_exact
from repro_torch.core.replay import (Replay, replay_add, replay_init,
                                     replay_sample, sample_indices)
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamState, adam, apply_updates


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    n_executors: int
    n_machines: int
    state_dim: int
    gamma: float = 0.99          # paper
    tau: float = 0.01            # paper
    k_nn: int = 12               # K nearest feasible actions
    batch: int = 32              # paper H
    buffer: int = 1000           # paper |B|
    # actor lr < critic lr: the deterministic-policy-gradient actor drifts
    # into critic-extrapolation regions over long online runs otherwise
    lr_actor: float = 2e-4
    lr_critic: float = 1e-3
    # rewards are negative milliseconds; an affine rescale keeps critic
    # targets O(1)
    reward_scale: float = 0.25
    eps: EpsilonSchedule = EpsilonSchedule()

    @property
    def action_dim(self) -> int:
        return self.n_executors * self.n_machines


@dataclasses.dataclass
class DDPGState:
    actor: nets.FleetMLP
    critic: nets.FleetMLP
    target_actor: nets.FleetMLP      # copies, never aliases of the online nets
    target_critic: nets.FleetMLP
    opt_actor: AdamState
    opt_critic: AdamState
    replay: Replay
    epoch: torch.Tensor              # [F] int32
    # running reward statistics: rewards are stored standardized
    # ((r − mean)/std) — an affine transform never changes the optimal policy
    r_mean: torch.Tensor             # [F]
    r_var: torch.Tensor              # [F]
    r_count: torch.Tensor            # [F] int32

    @property
    def fleet(self) -> int:
        return self.epoch.shape[0]


class OfflineDraws(NamedTuple):
    """Every random draw of ``offline_pretrain`` for ``F`` lanes, ``n``
    samples and ``U`` updates."""

    assignments: torch.Tensor   # [F, n, N] int, machine of each executor
    # standard normal, the env's shapes: [F, n, 5] and [F, n, S] on a DSDPS
    # env, [F, n] and [F, n, E] on the expert-placement env
    meas_z: torch.Tensor
    rate_z: torch.Tensor
    replay_idx: torch.Tensor    # [F, U, B] int


def _frozen_copy(net: nets.FleetMLP) -> nets.FleetMLP:
    return copy.deepcopy(net).requires_grad_(False)


def init_state(gen: torch.Generator | None, cfg: DDPGConfig, fleet: int,
               device: str | torch.device | None = None) -> DDPGState:
    """Fresh lanes on ``device`` (default CUDA; raises without a GPU)."""
    device = resolve_device(device)
    actor = nets.init_actor(cfg.state_dim, cfg.action_dim, fleet, gen, device)
    critic = nets.init_critic(cfg.state_dim, cfg.action_dim, fleet, gen, device)
    return DDPGState(
        actor=actor,
        critic=critic,
        target_actor=_frozen_copy(actor),
        target_critic=_frozen_copy(critic),
        opt_actor=adam(cfg.lr_actor).init(list(actor.parameters())),
        opt_critic=adam(cfg.lr_critic).init(list(critic.parameters())),
        replay=replay_init(fleet, cfg.buffer, cfg.state_dim, cfg.action_dim,
                           device),
        epoch=torch.zeros(fleet, dtype=torch.int32, device=device),
        r_mean=torch.zeros(fleet, device=device),
        r_var=torch.ones(fleet, device=device),
        r_count=torch.zeros(fleet, dtype=torch.int32, device=device),
    )


# --------------------------------------------------------------------------
# Action selection (lines 8-11): proto -> explore -> K-NN -> critic argmax
# --------------------------------------------------------------------------
@torch.no_grad()
def select_action(
    state: DDPGState,
    cfg: DDPGConfig,
    s_vec: torch.Tensor,
    explore: bool = True,
    add: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    gen: torch.Generator | None = None,
    exact_host_knn: bool = False,
    k_override: int | None = None,
) -> torch.Tensor:
    """One-hot assignments ``[F, ..., N, M]`` for states ``s_vec [F, ...,
    S]``: lane f's nets decide every row ``s_vec[f, ...]``, so a serving
    plane (F = 1) selects for all its slots in one pass, weights shared.

    With ``explore``, lane f's proto-actions get ``noise[f]`` when
    ``add[f]`` (the ε coin); draws not passed in come from ``gen``.
    ``k_override`` widens the K-NN set (deploy time uses a larger K than the
    per-epoch loop), and ``exact_host_knn`` takes it from the exact k-best
    enumeration on the host (``knn_actions_exact``, numpy) instead of the
    device beam — a copy to the host and back."""
    lead = s_vec.shape[:-1]
    k = k_override or cfg.k_nn
    proto = nets.apply_actor(state.actor, s_vec).reshape(
        *lead, cfg.n_executors, cfg.n_machines)
    if explore:
        proto = perturb_proto(proto, cfg.eps(state.epoch), add=add,
                              noise=noise, gen=gen)
    if exact_host_knn:
        rows = proto.reshape(-1, cfg.n_executors, cfg.n_machines).cpu().numpy()
        cands = torch.as_tensor(
            np.stack([knn_actions_exact(p, k) for p in rows]),
            device=proto.device).reshape(*lead, k, cfg.n_executors,
                                         cfg.n_machines)
    else:
        cands = knn_actions(proto, k)                             # [F, ..., K, N, M]
    q = nets.apply_critic(state.critic, s_vec[..., None, :],
                          cands.reshape(*lead, k, -1))            # [F, ..., K]
    best = q.argmax(-1)[..., None, None, None]
    return torch.take_along_dim(cands, best, dim=-3).squeeze(-3)


# --------------------------------------------------------------------------
# One learning update (lines 13-18)
# --------------------------------------------------------------------------
@torch.no_grad()
def _target_values(state: DDPGState, cfg: DDPGConfig, r, s_next):
    """y_i = r_i + γ max_{a∈A_K(f'(s'))} Q'(s', a)   (line 15), for
    ``s_next [F, B, S]``: one K-NN projection over all lanes and samples."""
    F, B = r.shape
    proto = nets.apply_actor(state.target_actor, s_next).reshape(
        F, B, cfg.n_executors, cfg.n_machines)
    cands = knn_actions(proto, cfg.k_nn)                          # [F, B, K, N, M]
    q = nets.apply_critic(state.target_critic, s_next[:, :, None, :],
                          cands.reshape(F, B, cfg.k_nn, -1))      # [F, B, K]
    return r + cfg.gamma * q.max(-1).values


def update_step(state: DDPGState, cfg: DDPGConfig,
                idx: torch.Tensor | None = None,
                gen: torch.Generator | None = None):
    """One critic + actor step on every lane, from the replay rows ``idx
    [F, B]`` (drawn from ``gen`` when not passed; float uniforms are scaled
    to each lane's filled rows, ``replay.sample_indices``); resets the reward
    statistics, as the reference does.  Returns (state, losses
    ``{"critic_loss": [F], "actor_loss": [F]}``)."""
    if idx is None or idx.is_floating_point():   # draw_epoch's uniforms
        idx = sample_indices(state.replay, cfg.batch, gen, u=idx)
    s, a, r, s_next = replay_sample(state.replay, idx)
    y = _target_values(state, cfg, r, s_next)

    critic_params = list(state.critic.parameters())
    q = nets.apply_critic(state.critic, s, a)                     # [F, B]
    c_loss = torch.square(y - q).mean(-1)
    c_grads = torch.autograd.grad(c_loss.sum(), critic_params)
    c_upd, state.opt_critic = adam(cfg.lr_critic).update(
        c_grads, state.opt_critic, critic_params)
    apply_updates(critic_params, c_upd)

    # deterministic policy gradient (line 17): ascend Q(s, f(s)) under the
    # UPDATED critic; the gradient is taken for the actor's parameters only
    actor_params = list(state.actor.parameters())
    protos = nets.apply_actor(state.actor, s)
    a_loss = -nets.apply_critic(state.critic, s, protos).mean(-1)
    a_grads = torch.autograd.grad(a_loss.sum(), actor_params)
    a_upd, state.opt_actor = adam(cfg.lr_actor).update(
        a_grads, state.opt_actor, actor_params)
    apply_updates(actor_params, a_upd)

    nets.soft_update(state.target_actor, state.actor, cfg.tau)
    nets.soft_update(state.target_critic, state.critic, cfg.tau)
    # as the reference does: its update_step rebuilds DDPGState without the
    # reward statistics, so every update resets them to (0, 1, 0).  A fault
    # of the reference (ROADMAP queue C), kept until both packages change.
    state.r_mean = torch.zeros_like(state.r_mean)
    state.r_var = torch.ones_like(state.r_var)
    state.r_count = torch.zeros_like(state.r_count)
    return state, {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach()}


@torch.no_grad()
def store(state: DDPGState, s, a, r, s_next,
          reward_scale: float = 1.0) -> DDPGState:
    """Standardize reward ``r [F]`` with the running statistics and append
    the transition to each lane's buffer."""
    r = r * reward_scale
    cnt = state.r_count + 1
    alpha = torch.clamp(1.0 / cnt.to(torch.float32), min=0.02)
    mean = state.r_mean + alpha * (r - state.r_mean)
    var = (1 - alpha) * state.r_var + alpha * torch.square(r - mean)
    r_std = (r - mean) / torch.clamp(torch.sqrt(var), min=1e-4)
    replay_add(state.replay, s, a, torch.clamp(r_std, -10, 10), s_next)
    state.r_mean, state.r_var, state.r_count = mean, var, cnt
    return state


def tick(state: DDPGState) -> DDPGState:
    state.epoch = state.epoch + 1
    return state


# --------------------------------------------------------------------------
# Offline training (line 4): fill the buffer with random-action
# transitions, then run gradient updates — paper: 10,000 samples.
# --------------------------------------------------------------------------
def offline_pretrain(
    state: DDPGState,
    cfg: DDPGConfig,
    env,
    n_samples: int = 10_000,
    n_updates: int = 2_000,
    env_params=None,
    draws: OfflineDraws | None = None,
    gen: torch.Generator | None = None,
) -> DDPGState:
    """Every lane collects its own ``n_samples`` random-action transitions
    and pretrains its own nets with ``n_updates`` updates."""
    params = env.default_params() if env_params is None else env_params
    F = state.fleet
    env_state = env.reset(F, params)
    S, A, R, SN = [], [], [], []
    with torch.no_grad():
        for t in range(n_samples):
            if draws is None:
                action = env.random_assignment(F, gen)
                meas_z = rate_z = None
            else:
                action = torch.nn.functional.one_hot(
                    draws.assignments[:, t].long(), env.M).to(torch.float32)
                meas_z, rate_z = draws.meas_z[:, t], draws.rate_z[:, t]
            out = env.step(env_state, action, params, meas_z=meas_z,
                           rate_z=rate_z, gen=gen)
            S.append(env.state_vector(env_state, params))
            A.append(action.reshape(F, -1))
            R.append(out.reward * cfg.reward_scale)
            SN.append(env.state_vector(out.state, params))
            env_state = out.state
        S, A, R, SN = (torch.stack(x, dim=1) for x in (S, A, R, SN))

        # keep the newest `capacity` samples, standardized over the whole
        # offline distribution (population std, as jnp.std)
        take = min(n_samples, state.replay.capacity)
        r_mean = R.mean(-1)
        r_std = torch.clamp(R.std(-1, correction=0), min=1e-4)
        r_norm = torch.clamp((R[:, -take:] - r_mean[:, None]) / r_std[:, None],
                             -10, 10)
        replay_add(state.replay, S[:, -take:], A[:, -take:], r_norm,
                   SN[:, -take:])
        state.r_mean = r_mean
        state.r_var = torch.square(r_std)
        state.r_count = torch.full_like(state.r_count, n_samples)

    for u in range(n_updates):
        idx = None if draws is None else draws.replay_idx[:, u]
        state, _ = update_step(state, cfg, idx=idx, gen=gen)
    return state


# --------------------------------------------------------------------------
# The Agent-interface adapter (core/api.py).
# --------------------------------------------------------------------------
def _agent_init(gen, cfg: DDPGConfig, fleet: int, device, env_params=None):
    return init_state(gen, cfg, fleet, device)


def _agent_select(cfg: DDPGConfig, state, s_vec, env_state, env_params,
                  explore, draws, gen):
    add = noise = None
    if draws is not None:
        add, noise = draws.explore_add, draws.explore_noise
    a = select_action(state, cfg, s_vec, explore=explore, add=add,
                      noise=noise, gen=gen)
    return a, a.reshape(a.shape[0], -1)


def _agent_observe(cfg: DDPGConfig, state, s_vec, aux, reward, s_next):
    return store(state, s_vec, aux, reward, s_next,
                 reward_scale=cfg.reward_scale)


def _agent_update(cfg: DDPGConfig, state, idx, gen):
    state, _ = update_step(state, cfg, idx=idx, gen=gen)
    return state


def _agent_tick(cfg: DDPGConfig, state):
    return tick(state)


def as_agent(cfg: DDPGConfig) -> api.Agent:
    """The actor-critic method as a pluggable Agent bundle."""
    return api.Agent(name="ddpg", cfg=cfg, init_fn=_agent_init,
                     select_fn=_agent_select, observe_fn=_agent_observe,
                     update_fn=_agent_update, tick_fn=_agent_tick)


def agent_factory(env, **overrides) -> api.Agent:
    """Registry hook: size a DDPGConfig for ``env`` (or pass ``cfg=``)."""
    cfg = overrides.pop("cfg", None)
    if cfg is None:
        cfg = DDPGConfig(n_executors=env.N, n_machines=env.M,
                         state_dim=env.state_dim, **overrides)
    return as_agent(cfg)


api.register_agent("ddpg", agent_factory)
