"""Actor / critic networks — the paper's §3.2.1 shapes, one per lane —
and the DQN baseline's Q-network.

Both are 2-layer fully-connected feedforward nets with 64 and 32 neurons
and tanh activations.  The actor maps a state to a proto-action in
[0, 1]^{N·M}; the critic maps (state, action) to a scalar Q value.

A :class:`FleetMLP` holds ``F`` independent nets: weights ``[F, din,
dout]`` (the reference's ``[din, dout]`` layout with the fleet axis in
front, so parameters carry across without transposes) and biases
``[F, dout]``, applied to inputs ``[F, ..., din]`` with one batched matmul
per layer."""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from repro_torch.device import resolve_device

HIDDEN = (64, 32)   # paper §3.2.1


class FleetMLP(nn.Module):
    """``F`` independent tanh MLPs with a linear output layer, built from
    weights ``[F, din, dout]`` and biases ``[F, dout]``."""

    def __init__(self, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor]):
        super().__init__()
        self.weights = nn.ParameterList([nn.Parameter(w) for w in weights])
        self.biases = nn.ParameterList([nn.Parameter(b) for b in biases])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [F, ..., din]`` → ``[F, ..., dout]``."""
        lead = x.shape[:-1]
        h = x.reshape(x.shape[0], -1, x.shape[-1])
        n = len(self.weights)
        for li, (w, b) in enumerate(zip(self.weights, self.biases)):
            if w.shape[-1] == 1:
                # a single output column as a product and a sum: CPU BLAS
                # picks another kernel for a one-lane batch of skinny
                # products, and a lane's values must not depend on the
                # number of lanes riding with it
                h = (h * w[:, None, :, 0]).sum(-1, keepdim=True) + b[:, None, :]
            else:
                h = torch.bmm(h, w) + b[:, None, :]
            if li < n - 1:
                h = torch.tanh(h)
        return h.reshape(*lead, h.shape[-1])


def init_mlp(sizes: Sequence[int], fleet: int,
             gen: torch.Generator | None = None,
             device: str | torch.device | None = None) -> FleetMLP:
    """Glorot-uniform init for a chain of Linear layers, one per lane, on
    ``device`` (default CUDA; raises without a GPU)."""
    device = resolve_device(device)
    ws, bs = [], []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        lim = math.sqrt(6.0 / (din + dout))
        u = torch.rand(fleet, din, dout, generator=gen, device=device)
        ws.append(u * (2 * lim) - lim)
        bs.append(torch.zeros(fleet, dout, device=device))
    return FleetMLP(ws, bs)


def sparse_init(sizes: Sequence[int], fleet: int, sparsity: float = 0.9,
                gen: torch.Generator | None = None,
                device: str | torch.device | None = None) -> FleetMLP:
    """Sparse LeCun-uniform init for the streaming agents (arXiv
    2410.14606), one net per lane: each layer draws U(−1/√fan_in,
    1/√fan_in) and zeroes exactly ``round(sparsity · fan_in)`` incoming
    weights of every output unit (the lowest ranks of a second uniform
    draw down each column).  Biases are zero; the hidden layers apply tanh,
    as every ``FleetMLP`` does."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1); got {sparsity}")
    device = resolve_device(device)
    ws, bs = [], []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        lim = 1.0 / math.sqrt(din)
        w = torch.rand(fleet, din, dout, generator=gen, device=device) * (2 * lim) - lim
        n_zero = int(round(sparsity * din))
        u = torch.rand(fleet, din, dout, generator=gen, device=device)
        ranks = u.argsort(dim=1).argsort(dim=1)
        ws.append(torch.where(ranks < n_zero, 0.0, w))
        bs.append(torch.zeros(fleet, dout, device=device))
    return FleetMLP(ws, bs)


def init_actor(state_dim: int, action_dim: int, fleet: int,
               gen: torch.Generator | None = None,
               device: str | torch.device | None = None) -> FleetMLP:
    return init_mlp((state_dim, *HIDDEN, action_dim), fleet, gen, device)


def apply_actor(actor: FleetMLP, state: torch.Tensor) -> torch.Tensor:
    """proto-action in [0, 1]^{action_dim} (row-simplex-ish via sigmoid)."""
    return torch.sigmoid(actor(state))


def init_critic(state_dim: int, action_dim: int, fleet: int,
                gen: torch.Generator | None = None,
                device: str | torch.device | None = None) -> FleetMLP:
    return init_mlp((state_dim + action_dim, *HIDDEN, 1), fleet, gen, device)


def apply_critic(critic: FleetMLP, state: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
    """Q(s, a) on concat(s, a); the leading axes of ``state [..., S]`` and
    ``action [..., A]`` broadcast (e.g. ``[F, 1, S]`` against
    ``[F, K, A]``)."""
    lead = torch.broadcast_shapes(state.shape[:-1], action.shape[:-1])
    x = torch.cat([state.expand(*lead, state.shape[-1]),
                   action.expand(*lead, action.shape[-1])], dim=-1)
    return critic(x)[..., 0]


def init_qnet(state_dim: int, num_actions: int, fleet: int,
              gen: torch.Generator | None = None,
              device: str | torch.device | None = None) -> FleetMLP:
    """DQN baseline: Q(s, ·) head over the restricted N×M move space."""
    return init_mlp((state_dim, *HIDDEN, num_actions), fleet, gen, device)


def apply_qnet(qnet: FleetMLP, state: torch.Tensor) -> torch.Tensor:
    """Q values ``[F, ..., num_actions]`` of states ``[F, ..., S]``."""
    return qnet(state)


@torch.no_grad()
def soft_update(target: FleetMLP, online: FleetMLP, tau: float) -> FleetMLP:
    """θ' ← τθ + (1−τ)θ'  (paper: τ = 0.01), in place on ``target``."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_((1.0 - tau) * t + tau * o)
    return target
