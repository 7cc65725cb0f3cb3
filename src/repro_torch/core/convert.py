"""Carry agent states and environment parameters across from numpy.

The reference's ``DDPGState`` / ``EnvParams`` pytrees, after
``jax.tree.map(np.asarray, ·)``, are read here by attribute name only —
the port imports nothing of the reference.  A single lane's state (scalar
``epoch``) gains the fleet axis ``[1]``; a stacked fleet keeps its
``[F]``.  Target nets become copies: the reference's ``init_state``
shares the online arrays with them, and an in-place soft update here would
corrupt an alias."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.ddpg import DDPGState
from repro_torch.core.networks import FleetMLP
from repro_torch.core.replay import Replay
from repro_torch.dsdps.simulator import EnvParams
from repro_torch.train.optimizer import AdamState


class MLPArrays(NamedTuple):
    weights: tuple
    biases: tuple


class AdamArrays(NamedTuple):
    step: np.ndarray
    mu: MLPArrays
    nu: MLPArrays


class ReplayArrays(NamedTuple):
    states: np.ndarray
    actions: np.ndarray
    rewards: np.ndarray
    next_states: np.ndarray
    ptr: np.ndarray
    size: np.ndarray


class DDPGArrays(NamedTuple):
    """The reference ``DDPGState``'s layout, every leaf stacked on [F]."""

    actor: MLPArrays
    critic: MLPArrays
    target_actor: MLPArrays
    target_critic: MLPArrays
    opt_actor: AdamArrays
    opt_critic: AdamArrays
    replay: ReplayArrays
    epoch: np.ndarray
    r_mean: np.ndarray
    r_var: np.ndarray
    r_count: np.ndarray


def ddpg_state_from_numpy(tree, device: str | torch.device) -> DDPGState:
    """A port ``DDPGState`` from a numpy ``DDPGState``-shaped tree."""
    lane_axis = np.ndim(tree.epoch) == 0

    def t(x, dtype=None):
        a = np.asarray(x)
        if lane_axis:
            a = a[None]
        return torch.tensor(a, dtype=dtype, device=device)

    def mlp(p, trainable: bool) -> FleetMLP:
        net = FleetMLP([t(w) for w in p.weights], [t(b) for b in p.biases])
        return net.requires_grad_(trainable)

    def adam_state(o) -> AdamState:
        return AdamState(step=t(o.step, torch.int32),
                         mu=[t(x) for x in (*o.mu.weights, *o.mu.biases)],
                         nu=[t(x) for x in (*o.nu.weights, *o.nu.biases)])

    rp = tree.replay
    return DDPGState(
        actor=mlp(tree.actor, True),
        critic=mlp(tree.critic, True),
        target_actor=mlp(tree.target_actor, False),
        target_critic=mlp(tree.target_critic, False),
        opt_actor=adam_state(tree.opt_actor),
        opt_critic=adam_state(tree.opt_critic),
        replay=Replay(states=t(rp.states), actions=t(rp.actions),
                      rewards=t(rp.rewards), next_states=t(rp.next_states),
                      ptr=t(rp.ptr, torch.int32), size=t(rp.size, torch.int32)),
        epoch=t(tree.epoch, torch.int32),
        r_mean=t(tree.r_mean, torch.float32),
        r_var=t(tree.r_var, torch.float32),
        r_count=t(tree.r_count, torch.int32),
    )


def ddpg_state_to_numpy(state: DDPGState) -> DDPGArrays:
    """The state as numpy arrays in the reference's layout, stacked on [F]."""
    def a(x):
        return x.detach().cpu().numpy()

    def mlp(net: FleetMLP) -> MLPArrays:
        return MLPArrays(weights=tuple(a(w) for w in net.weights),
                         biases=tuple(a(b) for b in net.biases))

    def adam_state(o: AdamState) -> AdamArrays:
        n = len(o.mu) // 2          # weights first, then biases
        return AdamArrays(step=a(o.step),
                          mu=MLPArrays(tuple(map(a, o.mu[:n])),
                                       tuple(map(a, o.mu[n:]))),
                          nu=MLPArrays(tuple(map(a, o.nu[:n])),
                                       tuple(map(a, o.nu[n:]))))

    rp = state.replay
    return DDPGArrays(
        actor=mlp(state.actor), critic=mlp(state.critic),
        target_actor=mlp(state.target_actor),
        target_critic=mlp(state.target_critic),
        opt_actor=adam_state(state.opt_actor),
        opt_critic=adam_state(state.opt_critic),
        replay=ReplayArrays(a(rp.states), a(rp.actions), a(rp.rewards),
                            a(rp.next_states), a(rp.ptr), a(rp.size)),
        epoch=a(state.epoch), r_mean=a(state.r_mean), r_var=a(state.r_var),
        r_count=a(state.r_count),
    )


def env_params_from_numpy(tree, device: str | torch.device) -> EnvParams:
    """A port ``EnvParams`` from a numpy ``EnvParams``-shaped tree (dtypes
    kept: float32 leaves, int32 ``shift_epoch``)."""
    return EnvParams(**{f: torch.tensor(np.asarray(getattr(tree, f)),
                                        device=device)
                        for f in EnvParams._fields})
