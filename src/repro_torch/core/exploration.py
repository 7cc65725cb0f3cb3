"""Exploration policy R(â) = â + εI  (paper §3.2.1, line 9).

ε is the probability of perturbing the proto-action with uniform noise
I ~ U[0,1]^{N·M}; it decays with the decision epoch so later epochs act
greedily.  The DQN baseline uses the standard ε-greedy over its move
space.  Port of ``repro/core/exploration.py`` with the coin flip, the
noise and the random move passed in, one per lane."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EpsilonSchedule:
    eps_start: float = 1.0
    eps_end: float = 0.02
    decay_epochs: int = 800

    def __call__(self, epoch: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(epoch.to(torch.float32) / self.decay_epochs, 0.0, 1.0)
        return self.eps_start + frac * (self.eps_end - self.eps_start)


def perturb_proto(proto: torch.Tensor, eps: torch.Tensor,
                  add: torch.Tensor | None = None,
                  noise: torch.Tensor | None = None,
                  gen: torch.Generator | None = None) -> torch.Tensor:
    """With probability ``eps [F]`` add uniform noise in [0, 1) to each of
    lane f's proto-actions ``[F, ..., N, M]`` (one per row of a serving
    plane's ``[1, n_slots]``).  ``add [F, ...]`` (bool, one coin a
    proto-action; or a uniform in [0, 1), the coin ``add < eps``) and
    ``noise [F, ..., N, M]`` are the draws; those not passed in come from
    ``gen``."""
    lead = proto.shape[:-2]
    if add is None or add.is_floating_point():
        u = torch.rand(lead, generator=gen, device=proto.device) if add is None else add
        add = u < eps.reshape(-1, *(1,) * (len(lead) - 1))
    if noise is None:
        noise = torch.rand(proto.shape, generator=gen, device=proto.device)
    add = add.reshape(*lead, 1, 1)
    return torch.where(add, proto + noise, proto)


def epsilon_greedy(q_values: torch.Tensor, eps: torch.Tensor,
                   explore: torch.Tensor | None = None,
                   rand_a: torch.Tensor | None = None,
                   gen: torch.Generator | None = None) -> torch.Tensor:
    """DQN move selection over flat action values ``q_values [F, A]``: lane
    f takes the random move ``rand_a[f]`` when ``explore[f]`` (the ε coin,
    with probability ``eps [F]``; a uniform in [0, 1) is the coin
    ``explore < eps``), else its greedy move (the first maximum, as
    ``jnp.argmax``).  Draws not passed in come from ``gen``."""
    F, A = q_values.shape
    if explore is None or explore.is_floating_point():
        u = torch.rand(F, generator=gen, device=q_values.device) if explore is None \
            else explore
        explore = u < eps
    if rand_a is None:
        rand_a = torch.randint(0, A, (F,), generator=gen, device=q_values.device)
    return torch.where(explore, rand_a.long(), q_values.argmax(-1))
