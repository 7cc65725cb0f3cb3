"""Shared machinery of the replay-free streaming agents (arXiv 2410.14606).

Port of ``repro/core/streaming.py``, per lane over a fleet axis ``[F]``.
Stream Q(λ) and Stream AC(λ) replace the replay buffer, target network and
Adam state of the DQN/DDPG lanes with three small pieces:

  * :class:`ObsNorm`: a running Welford mean/variance of the observations,
    updated once per transition;
  * eligibility traces: tensors shaped like the network's parameters,
    decayed by γλ and accumulated with the transition's gradient
    (:func:`trace_decay_add`);
  * ObGD (:func:`obgd_step`): overshoot-bounded gradient descent, which
    throttles the stepsize so one update cannot overshoot the TD target.

:func:`reward_norm_update` is the running reward standardization the
replay agents keep in their states.  Parameters and traces are lists of
tensors with the lane axis first (``FleetMLP.parameters()`` order, or a
param dict's leaves); ``trace_decay_add`` and ``obgd_step`` update them
in place."""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class ObsNorm(NamedTuple):
    """Welford running mean/variance over observation vectors, per lane."""

    mean: torch.Tensor    # [F, dim]
    m2: torch.Tensor      # [F, dim] sum of squared deviations
    count: torch.Tensor   # [F] float32


def _per_lane(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane ``[F]`` value shaped to broadcast against ``like``'s
    ``[F, ...]``."""
    return x.reshape(x.shape[0], *(1,) * (like.dim() - 1))


def norm_init(dim: int, fleet: int, device) -> ObsNorm:
    return ObsNorm(mean=torch.zeros(fleet, dim, device=device),
                   m2=torch.zeros(fleet, dim, device=device),
                   count=torch.zeros(fleet, device=device))


def norm_update(norm: ObsNorm, x: torch.Tensor) -> ObsNorm:
    """Fold one observation ``x [F, dim]`` per lane into the statistics."""
    count = norm.count + 1.0
    delta = x - norm.mean
    mean = norm.mean + delta / count[:, None]
    m2 = norm.m2 + delta * (x - mean)
    return ObsNorm(mean=mean, m2=m2, count=count)


def norm_apply(norm: ObsNorm, x: torch.Tensor) -> torch.Tensor:
    """Standardize ``x [F, dim]`` under each lane's statistics, clipped to
    ±10; until a lane has folded in two observations its variance is 1."""
    count = norm.count[:, None]
    var = torch.where(count > 1.0, norm.m2 / torch.clamp(count, min=1.0),
                      torch.ones_like(norm.m2))
    return torch.clamp((x - norm.mean) / torch.sqrt(var + 1e-8), -10.0, 10.0)


def reward_norm_update(r, mean, var, count, scale: float = 1.0):
    """Running reward standardization (the scheme of ddpg/dqn ``store``),
    all ``[F]``.  Returns ``(r_std, mean, var, count)``."""
    r = r * scale
    cnt = count + 1
    alpha = torch.clamp(1.0 / cnt.to(torch.float32), min=0.02)
    new_mean = mean + alpha * (r - mean)
    new_var = (1 - alpha) * var + alpha * torch.square(r - new_mean)
    r_std = torch.clamp((r - new_mean) / torch.clamp(torch.sqrt(new_var), min=1e-4),
                        -10.0, 10.0)
    return r_std, new_mean, new_var, cnt


@torch.no_grad()
def trace_decay_add(traces: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                    decay) -> None:
    """z ← decay·z + g, leaf by leaf, in place; ``decay`` is a number or
    ``[F]`` (γλ, or γλ·1{greedy} for Stream Q(λ)'s Watkins cut)."""
    for z, g in zip(traces, grads):
        z.mul_(_per_lane(decay, z) if isinstance(decay, torch.Tensor) else decay)
        z.add_(g)


def trace_zeros_like(params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    return [torch.zeros_like(p, requires_grad=False) for p in params]


def gumbel(shape, gen: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in [tiny, 1): a
    categorical draw is ``argmax(gumbel + logits)``, as
    ``jax.random.categorical`` computes it."""
    u = torch.rand(shape, generator=gen, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def obgd_step(params: Sequence[torch.Tensor], traces: Sequence[torch.Tensor],
              delta: torch.Tensor, lr: float, kappa: float) -> None:
    """Overshoot-bounded gradient descent (arXiv 2410.14606, Algorithm 3),
    in place, per lane: ``w ← w + α_eff·δ·z`` with

        δ̄ = max(|δ|, 1),  M = α·κ·δ̄·‖z‖₁,  α_eff = α / max(M, 1),

    where ‖z‖₁ sums every trace leaf of the lane (never across lanes).
    δ = 0 (a consumed update) leaves the parameters as they were, so
    ``updates_per_epoch > 1`` applies each transition once."""
    z_l1 = sum(z.abs().flatten(1).sum(1) for z in traces)            # [F]
    delta_bar = torch.clamp(delta.abs(), min=1.0)
    bound = lr * kappa * delta_bar * z_l1
    step = lr / torch.clamp(bound, min=1.0)
    coef = step * delta
    for p, z in zip(params, traces):
        p.add_(_per_lane(coef, z) * z)
