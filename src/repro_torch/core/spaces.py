"""State/action-space algebra for the scheduling problem (paper §3.2).

Port of ``repro/core/spaces.py``.  Action a ∈ {0,1}^{N×M} with row-simplex
constraints Σ_j a_ij = 1; state s = (X, w).

The module also carries the ACTION-SPACE REGISTRY: the serving control
plane (``serve/control.py``) dispatches decision kinds by name, and each
kind is an :class:`ActionSpace` — its per-env action shape, its
feasibility predicate, and the registered default agent that serves it.
Builtins: ``placement`` (the paper's [N, M] assignment), ``rate_control``
(per-spout admission throttles) and ``auto_tune`` (config-knob operating
points), whose simulator semantics live in ``repro_torch.dsdps.actions``."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def is_feasible(action: torch.Tensor, atol: float = 1e-6) -> torch.Tensor:
    """Checks the MIQP-NN constraint set: binary rows summing to one."""
    binary = torch.all(torch.abs(action * (1.0 - action)) < atol)
    rows = torch.all(torch.abs(action.sum(-1) - 1.0) < atol)
    return torch.logical_and(binary, rows)


def assignment_to_machines(action: torch.Tensor) -> torch.Tensor:
    return torch.argmax(action, dim=-1)


def machines_to_assignment(machines: torch.Tensor,
                           n_machines: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(machines.long(), n_machines).to(
        torch.float32)


def hamming_moves(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Number of executors whose machine differs between two assignments —
    the deployment cost of the minimal-delta re-assignment (paper §3.1)."""
    return (assignment_to_machines(a) != assignment_to_machines(b)).sum(-1)


def action_space_size(n_executors: int, n_machines: int) -> int:
    return n_machines ** n_executors


# --------------------------------------------------------------------------
# Action-space registry — the decision surface the serving control plane
# dispatches over.  Every space's actions are one-hot rows, so the single
# MIQP-NN predicate above validates all of them (a 1-D action is one row).
# --------------------------------------------------------------------------
class ActionSpace(NamedTuple):
    """One decision kind: name, per-env action shape, feasibility test,
    and the registry name of the agent that serves it by default."""

    name: str
    shape_fn: Callable[[Any], tuple[int, ...]]
    feasible_fn: Callable[[torch.Tensor], torch.Tensor]
    default_agent: str


_ACTION_SPACES: dict[str, ActionSpace] = {}


def register_action_space(space: ActionSpace) -> None:
    """Register a decision kind for ``action_space(name)`` lookup (and
    therefore for ``serve.control.ControlPlane(kind=name)``)."""
    _ACTION_SPACES[space.name] = space


def action_space(name: str) -> ActionSpace:
    try:
        return _ACTION_SPACES[name]
    except KeyError:
        raise KeyError(f"unknown action space {name!r}; "
                       f"known: {sorted(_ACTION_SPACES)}") from None


def action_space_names() -> tuple[str, ...]:
    return tuple(sorted(_ACTION_SPACES))


def _placement_shape(env) -> tuple[int, ...]:
    return (env.N, env.M)


def _rate_shape(env) -> tuple[int, ...]:
    # lazy import: spaces is a core leaf module; the rate grid lives with
    # its simulator semantics in dsdps
    from repro_torch.dsdps.actions import RATE_LEVELS
    return (env.workload.num_spouts, len(RATE_LEVELS))


def _tune_shape(env) -> tuple[int, ...]:
    from repro_torch.dsdps.actions import TUNE_GRID
    return (len(TUNE_GRID),)


register_action_space(ActionSpace("placement", _placement_shape,
                                  is_feasible, "ddpg"))
register_action_space(ActionSpace("rate_control", _rate_shape,
                                  is_feasible, "rate_control"))
register_action_space(ActionSpace("auto_tune", _tune_shape,
                                  is_feasible, "auto_tune"))
