"""Carry agent states and environment parameters across from numpy.

The reference's ``DDPGState`` / ``DQNState`` / ``StreamQState`` /
``StreamACState`` / ``GraphPolicyState`` / ``EnvParams`` /
``GraphEnvParams`` / ``PlacementParams`` / ``PlacementState`` pytrees, after
``jax.tree.map(np.asarray, ·)``, are read here by attribute name only —
the port imports nothing of the reference.  A single lane's state (scalar
``epoch``) gains the fleet axis ``[1]``; a stacked fleet keeps its
``[F]``.  Target nets become copies: the reference's ``init_state``
shares the online arrays with them, and an in-place soft update here would
corrupt an alias.  The model-based baseline's state is its fitted theta,
``[5M + 8]`` for one lane or ``[F, 5M + 8]``."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.ddpg import DDPGState
from repro_torch.core.dqn import DQNState
from repro_torch.core.graph_policy import GraphPolicyState, tree_map
from repro_torch.core.networks import FleetMLP
from repro_torch.core.placement import PlacementParams, PlacementState
from repro_torch.core.replay import Replay
from repro_torch.core.stream_ac import StreamACState
from repro_torch.core.stream_q import StreamQState
from repro_torch.core.streaming import ObsNorm
from repro_torch.dsdps.simulator import EnvParams
from repro_torch.dsdps.structural import GraphEnvParams
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


class DQNArrays(NamedTuple):
    """The reference ``DQNState``'s layout, every leaf stacked on [F]."""

    qnet: MLPArrays
    target: MLPArrays
    opt: AdamArrays
    replay: ReplayArrays
    epoch: np.ndarray
    r_mean: np.ndarray
    r_var: np.ndarray
    r_count: np.ndarray


class ObsNormArrays(NamedTuple):
    mean: np.ndarray
    m2: np.ndarray
    count: np.ndarray


class StreamQArrays(NamedTuple):
    """The reference ``StreamQState``'s layout, every leaf stacked on [F]."""

    qnet: MLPArrays
    z: MLPArrays
    norm: ObsNormArrays
    delta: np.ndarray
    epoch: np.ndarray
    r_mean: np.ndarray
    r_var: np.ndarray
    r_count: np.ndarray


class StreamACArrays(NamedTuple):
    """The reference ``StreamACState``'s layout, every leaf stacked on [F]."""

    actor: MLPArrays
    critic: MLPArrays
    z_actor: MLPArrays
    z_critic: MLPArrays
    norm: ObsNormArrays
    delta: np.ndarray
    epoch: np.ndarray
    r_mean: np.ndarray
    r_var: np.ndarray
    r_count: np.ndarray


class GraphPolicyArrays(NamedTuple):
    """The reference ``GraphPolicyState``'s layout (param dicts of numpy
    arrays), every leaf stacked on [F]."""

    qnet: dict
    z: dict
    delta: np.ndarray
    epoch: np.ndarray
    r_mean: np.ndarray
    r_var: np.ndarray
    r_count: np.ndarray


class _FromNumpy:
    """Numpy leaves of one state tree to tensors on ``device``, adding the
    fleet axis when the tree is a single lane."""

    def __init__(self, tree, device):
        self.lane_axis = np.ndim(tree.epoch) == 0
        self.device = device

    def t(self, x, dtype=None) -> torch.Tensor:
        a = np.asarray(x)
        if self.lane_axis:
            a = a[None]
        return torch.tensor(a, dtype=dtype, device=self.device)

    def mlp(self, p, trainable: bool) -> FleetMLP:
        net = FleetMLP([self.t(w) for w in p.weights],
                       [self.t(b) for b in p.biases])
        return net.requires_grad_(trainable)

    def adam(self, o) -> AdamState:
        t = self.t
        return AdamState(step=t(o.step, torch.int32),
                         mu=[t(x) for x in (*o.mu.weights, *o.mu.biases)],
                         nu=[t(x) for x in (*o.nu.weights, *o.nu.biases)])

    def replay(self, rp) -> Replay:
        t = self.t
        return Replay(states=t(rp.states), actions=t(rp.actions),
                      rewards=t(rp.rewards), next_states=t(rp.next_states),
                      ptr=t(rp.ptr, torch.int32), size=t(rp.size, torch.int32))

    def stats(self, tree) -> dict:
        t = self.t
        return dict(epoch=t(tree.epoch, torch.int32),
                    r_mean=t(tree.r_mean, torch.float32),
                    r_var=t(tree.r_var, torch.float32),
                    r_count=t(tree.r_count, torch.int32))

    def traces(self, p) -> list:
        """An ``MLPParams``-shaped trace tree as the port's list
        (``FleetMLP.parameters()`` order: weights, then biases)."""
        return [self.t(x, torch.float32) for x in (*p.weights, *p.biases)]

    def norm(self, n) -> ObsNorm:
        t = self.t
        return ObsNorm(mean=t(n.mean, torch.float32), m2=t(n.m2, torch.float32),
                       count=t(n.count, torch.float32))

    def streaming(self, tree) -> dict:
        return dict(delta=self.t(tree.delta, torch.float32), **self.stats(tree))


def _a(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _mlp_arrays(net: FleetMLP) -> MLPArrays:
    return MLPArrays(weights=tuple(_a(w) for w in net.weights),
                     biases=tuple(_a(b) for b in net.biases))


def _adam_arrays(o: AdamState) -> AdamArrays:
    n = len(o.mu) // 2          # weights first, then biases
    return AdamArrays(step=_a(o.step),
                      mu=MLPArrays(tuple(map(_a, o.mu[:n])),
                                   tuple(map(_a, o.mu[n:]))),
                      nu=MLPArrays(tuple(map(_a, o.nu[:n])),
                                   tuple(map(_a, o.nu[n:]))))


def _replay_arrays(rp: Replay) -> ReplayArrays:
    return ReplayArrays(_a(rp.states), _a(rp.actions), _a(rp.rewards),
                        _a(rp.next_states), _a(rp.ptr), _a(rp.size))


def _trace_arrays(z: list) -> MLPArrays:
    n = len(z) // 2             # weights first, then biases
    return MLPArrays(tuple(map(_a, z[:n])), tuple(map(_a, z[n:])))


def _norm_arrays(n: ObsNorm) -> ObsNormArrays:
    return ObsNormArrays(_a(n.mean), _a(n.m2), _a(n.count))


def lane_arrays(tree, lane: int):
    """Lane ``lane`` of a numpy state tree stacked on [F] (what
    ``*_state_to_numpy`` returns) as a fleet of one: every leaf ``[1, ...]``."""
    if isinstance(tree, tuple):
        parts = (lane_arrays(x, lane) for x in tree)
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    if isinstance(tree, dict):
        return {k: lane_arrays(v, lane) for k, v in tree.items()}
    return tree[lane:lane + 1]


def ddpg_state_from_numpy(tree, device: str | torch.device) -> DDPGState:
    """A port ``DDPGState`` from a numpy ``DDPGState``-shaped tree."""
    c = _FromNumpy(tree, device)
    return DDPGState(
        actor=c.mlp(tree.actor, True),
        critic=c.mlp(tree.critic, True),
        target_actor=c.mlp(tree.target_actor, False),
        target_critic=c.mlp(tree.target_critic, False),
        opt_actor=c.adam(tree.opt_actor),
        opt_critic=c.adam(tree.opt_critic),
        replay=c.replay(tree.replay),
        **c.stats(tree),
    )


def ddpg_state_to_numpy(state: DDPGState) -> DDPGArrays:
    """The state as numpy arrays in the reference's layout, stacked on [F]."""
    return DDPGArrays(
        actor=_mlp_arrays(state.actor), critic=_mlp_arrays(state.critic),
        target_actor=_mlp_arrays(state.target_actor),
        target_critic=_mlp_arrays(state.target_critic),
        opt_actor=_adam_arrays(state.opt_actor),
        opt_critic=_adam_arrays(state.opt_critic),
        replay=_replay_arrays(state.replay),
        epoch=_a(state.epoch), r_mean=_a(state.r_mean), r_var=_a(state.r_var),
        r_count=_a(state.r_count),
    )


def dqn_state_from_numpy(tree, device: str | torch.device) -> DQNState:
    """A port ``DQNState`` from a numpy ``DQNState``-shaped tree."""
    c = _FromNumpy(tree, device)
    return DQNState(qnet=c.mlp(tree.qnet, True),
                    target=c.mlp(tree.target, False),
                    opt=c.adam(tree.opt), replay=c.replay(tree.replay),
                    **c.stats(tree))


def dqn_state_to_numpy(state: DQNState) -> DQNArrays:
    """The state as numpy arrays in the reference's layout, stacked on [F]."""
    return DQNArrays(qnet=_mlp_arrays(state.qnet),
                     target=_mlp_arrays(state.target),
                     opt=_adam_arrays(state.opt),
                     replay=_replay_arrays(state.replay),
                     epoch=_a(state.epoch), r_mean=_a(state.r_mean),
                     r_var=_a(state.r_var), r_count=_a(state.r_count))


def stream_q_state_from_numpy(tree, device: str | torch.device) -> StreamQState:
    """A port ``StreamQState`` from a numpy ``StreamQState``-shaped tree."""
    c = _FromNumpy(tree, device)
    return StreamQState(qnet=c.mlp(tree.qnet, True), z=c.traces(tree.z),
                        norm=c.norm(tree.norm), **c.streaming(tree))


def stream_q_state_to_numpy(state: StreamQState) -> StreamQArrays:
    """The state as numpy arrays in the reference's layout, stacked on [F]."""
    return StreamQArrays(qnet=_mlp_arrays(state.qnet), z=_trace_arrays(state.z),
                         norm=_norm_arrays(state.norm), delta=_a(state.delta),
                         epoch=_a(state.epoch), r_mean=_a(state.r_mean),
                         r_var=_a(state.r_var), r_count=_a(state.r_count))


def stream_ac_state_from_numpy(tree, device: str | torch.device) -> StreamACState:
    """A port ``StreamACState`` from a numpy ``StreamACState``-shaped tree."""
    c = _FromNumpy(tree, device)
    return StreamACState(actor=c.mlp(tree.actor, True),
                         critic=c.mlp(tree.critic, True),
                         z_actor=c.traces(tree.z_actor),
                         z_critic=c.traces(tree.z_critic),
                         norm=c.norm(tree.norm), **c.streaming(tree))


def stream_ac_state_to_numpy(state: StreamACState) -> StreamACArrays:
    """The state as numpy arrays in the reference's layout, stacked on [F]."""
    return StreamACArrays(
        actor=_mlp_arrays(state.actor), critic=_mlp_arrays(state.critic),
        z_actor=_trace_arrays(state.z_actor),
        z_critic=_trace_arrays(state.z_critic), norm=_norm_arrays(state.norm),
        delta=_a(state.delta), epoch=_a(state.epoch), r_mean=_a(state.r_mean),
        r_var=_a(state.r_var), r_count=_a(state.r_count))


def graph_policy_state_from_numpy(tree, device: str | torch.device
                                  ) -> GraphPolicyState:
    """A port ``GraphPolicyState`` from a numpy ``GraphPolicyState``-shaped
    tree (param dicts)."""
    c = _FromNumpy(tree, device)
    return GraphPolicyState(
        qnet=tree_map(lambda x: c.t(x, torch.float32).requires_grad_(True),
                      tree.qnet),
        z=tree_map(lambda x: c.t(x, torch.float32), tree.z),
        **c.streaming(tree))


def graph_policy_state_to_numpy(state: GraphPolicyState) -> GraphPolicyArrays:
    """The state as numpy arrays in the reference's layout, stacked on [F]."""
    return GraphPolicyArrays(
        qnet=tree_map(_a, state.qnet), z=tree_map(_a, state.z),
        delta=_a(state.delta), epoch=_a(state.epoch), r_mean=_a(state.r_mean),
        r_var=_a(state.r_var), r_count=_a(state.r_count))


def model_based_state_from_numpy(theta, device: str | torch.device
                                 ) -> torch.Tensor:
    """The model-based lanes' fitted theta ``[F, 5M + 8]`` (one lane's
    ``[5M + 8]`` gains the fleet axis)."""
    a = np.asarray(theta, np.float32)
    return torch.tensor(a[None] if a.ndim == 1 else a, device=device)


def env_params_from_numpy(tree, device: str | torch.device) -> EnvParams:
    """A port ``EnvParams`` from a numpy ``EnvParams``-shaped tree (dtypes
    kept: float32 leaves, int32 ``shift_epoch``): one scenario, or a
    lane-stacked fleet, broadcast-invariant fields single-copy as given."""
    return EnvParams(**{f: torch.tensor(np.asarray(getattr(tree, f)),
                                        device=device)
                        for f in EnvParams._fields})


def graph_env_params_from_numpy(tree, device: str | torch.device
                                ) -> GraphEnvParams:
    """A port ``GraphEnvParams`` from a numpy ``GraphEnvParams``-shaped tree
    (dtypes kept: float32 leaves, int32 ``shift_epoch``, ``edge_src`` and
    ``edge_dst``): one lane, or a lane-stacked fleet."""
    return GraphEnvParams(**{f: torch.tensor(np.asarray(getattr(tree, f)),
                                             device=device)
                             for f in GraphEnvParams._fields})


def placement_params_from_numpy(tree, device: str | torch.device
                                ) -> PlacementParams:
    """A port ``PlacementParams`` from a numpy ``PlacementParams``-shaped
    tree (float32 leaves): one scenario, or a lane-stacked fleet,
    broadcast-invariant fields single-copy as given."""
    return PlacementParams(**{f: torch.tensor(np.asarray(getattr(tree, f)),
                                              device=device)
                              for f in PlacementParams._fields})


def placement_params_to_numpy(params: PlacementParams) -> PlacementParams:
    """The same fields as numpy arrays (a ``PlacementParams`` of arrays)."""
    return PlacementParams(*(_a(x) for x in params))


def placement_state_from_numpy(tree, device: str | torch.device
                               ) -> PlacementState:
    """A port ``PlacementState`` from a numpy one: a fleet's leaves, or one
    lane's (``X [E, D]``), which gains the fleet axis."""
    lone = np.asarray(tree.X).ndim == 2
    return PlacementState(**{
        f: torch.tensor(np.asarray(getattr(tree, f))[None] if lone
                        else np.asarray(getattr(tree, f)), device=device)
        for f in PlacementState._fields})
