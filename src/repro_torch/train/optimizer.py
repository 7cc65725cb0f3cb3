"""Adam / AdamW with the reference's formula, one step counter per lane.

Port of the Adam half of ``repro/train/optimizer.py``:

    m ← b1·m + (1−b1)·g          v ← b2·v + (1−b2)·g²
    u = (m/c1) / (sqrt(v/c2) + eps),   c1 = 1 − b1^t,  c2 = 1 − b2^t

(``torch.optim.Adam`` places ``eps`` differently and keeps one step count
for all lanes, so it is not used).  Parameters carry the fleet axis
``[F, ...]``; ``step`` is ``[F]``.  Schedules, clipping and SGD wait for
the LM slice."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor            # [F] int32
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # decoupled weight decay on per-lane matrices (ndim >= 2 per lane)
    weight_decay: float = 0.0

    def init(self, params: list[torch.Tensor]) -> AdamState:
        fleet = params[0].shape[0]
        return AdamState(
            step=torch.zeros(fleet, dtype=torch.int32, device=params[0].device),
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
        )

    @torch.no_grad()
    def update(self, grads, state: AdamState, params):
        """(updates, new state) for ``grads``; nothing is written in place."""
        b1, b2 = self.b1, self.b2
        step = state.step + 1
        t = step.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        mu = [b1 * m + (1 - b1) * g for m, g in zip(state.mu, grads)]
        nu = [b2 * v + (1 - b2) * torch.square(g) for v, g in zip(state.nu, grads)]
        updates = []
        for m, v, p in zip(mu, nu, params):
            shape = (-1,) + (1,) * (p.dim() - 1)
            u = (m / c1.view(shape)) / (torch.sqrt(v / c2.view(shape)) + self.eps)
            if self.weight_decay and p.dim() >= 3:
                u = u + self.weight_decay * p
            updates.append(-self.learning_rate * u)
        return updates, AdamState(step=step, mu=mu, nu=nu)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    return Optimizer(learning_rate, b1, b2, eps, weight_decay)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return Optimizer(learning_rate, b1, b2, eps, 0.0)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """``p ← p + u`` in place."""
    for p, u in zip(params, updates):
        p.add_(u)
