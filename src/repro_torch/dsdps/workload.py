"""Workload (spout arrival-rate) processes.

``WorkloadProcess`` is the declarative spec; ``step_rates`` is the
transition function, batched over the fleet axis, with its standard-normal
draw passed in explicitly (``repro/dsdps/workload.py`` draws it from a JAX
key inside)."""
from __future__ import annotations

import dataclasses

import torch

# Sentinel "never shifts" epoch: the Fig-12 step change is expressed as
# `epoch >= shift_epoch`, so an epoch no run reaches disables it.
NEVER_SHIFT: int = 2 ** 30


def step_rates(
    w: torch.Tensor,             # [F, S]
    epoch: torch.Tensor,         # [F] int
    base_rates: torch.Tensor,    # [S], or [F, S] per lane
    jitter: torch.Tensor,        # scalar, or [F] per lane (so the rest)
    revert: torch.Tensor,
    shift_epoch: torch.Tensor,
    shift_factor: torch.Tensor,
    z: torch.Tensor,             # [F, S] standard normal
) -> torch.Tensor:
    """One epoch of the mean-reverting multiplicative random walk.  Each
    rate parameter is one value for every lane or one per lane."""
    shifted = (epoch >= shift_epoch)[:, None]
    base = torch.where(shifted, base_rates * shift_factor[..., None],
                       base_rates)
    target = base * torch.exp(z * jitter[..., None])
    return w + revert[..., None] * (target - w)


@dataclasses.dataclass(frozen=True)
class WorkloadProcess:
    """Mean-reverting multiplicative random walk around a base rate, with an
    optional step change (Fig 12's +50% shift at a given epoch)."""

    base_rates: tuple[float, ...]       # tuples/sec per spout executor
    jitter: float = 0.05                # per-epoch lognormal sigma
    revert: float = 0.2                 # pull toward base
    shift_epoch: int | None = None      # epoch at which rates jump
    shift_factor: float = 1.5

    @property
    def num_spouts(self) -> int:
        return len(self.base_rates)


def constant(rates: tuple[float, ...]) -> WorkloadProcess:
    """A workload that holds ``rates``: no jitter, full reversion."""
    return WorkloadProcess(base_rates=rates, jitter=0.0, revert=1.0)
