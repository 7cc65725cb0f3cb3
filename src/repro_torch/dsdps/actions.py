"""Decision semantics beyond placement: rate control and auto-tuning.

Port of ``repro/dsdps/actions.py``.  The paper's action is an
executor→machine assignment, but the same model-free control loop
generalises to two adjacent decision kinds (PAPERS.md): *rate control* —
per-spout admission throttles — and *auto-tuning* — runtime config knobs.
Both act on the SAME simulator: a decision is a pure edit of the
:class:`~repro_torch.dsdps.simulator.EnvParams` (scale ``base_rates``;
scale ``acker_ms`` / ``tuple_bytes``).

Encodings (both one-hot, so the MIQP-NN row-simplex feasibility predicate
from ``core/spaces.py`` applies):

* rate_control — ``[S, L]``: row s one-hot over :data:`RATE_LEVELS`,
  a discrete throttle grid of admission multipliers for spout s.
* auto_tune   — ``[K]``: one-hot over :data:`TUNE_GRID`, joint
  (acker overhead scale, tuple batch-size scale) operating points.

Every function takes one action with one EnvParams, or a batch of actions
``[R, ...]`` with an EnvParams whose fields are single or stacked on the
same ``[R]`` (``simulator.stack_env_params``); a batch of actions on a
single EnvParams gives a stacked one.  Fields are indexed from the right,
so a stacked field broadcasts row by row.

``decode_state`` recovers the simulator state (X, w) from the flattened
state vector the DNNs see — the serving control plane receives only
``(s_vec, cluster params)`` per request."""
from __future__ import annotations

import functools

import torch

from repro_torch.dsdps.simulator import EnvParams

# Admission throttle grid: fraction of the offered spout load admitted.
# 1.0 = no throttling; the levels match the coarse-grained backpressure
# settings a Storm operator can actually deploy.
RATE_LEVELS: tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)

# Auto-tuning knob grid: (acker_scale, batch_scale) operating points.
# acker_scale scales the per-tuple ack/bookkeeping overhead (Storm's
# acker-executor setting: fewer ackers = less bookkeeping, weaker
# delivery guarantees); batch_scale scales tuple_bytes (transfer
# batching: bigger batches amortise per-tuple framing but pay
# serialization + wire time on every cross-machine hop).
TUNE_GRID: tuple[tuple[float, float], ...] = (
    (1.0, 1.0),     # declared configuration
    (0.5, 1.0),     # halve ack bookkeeping
    (0.25, 1.0),    # minimal acking
    (1.0, 0.5),     # smaller transfer batches
    (1.0, 2.0),     # bigger transfer batches
    (0.5, 0.5),     # both: low-latency profile
)


@functools.lru_cache(maxsize=None)
def grid_tensor(values: tuple, device: str) -> torch.Tensor:
    """A grid (``RATE_LEVELS``, ``TUNE_GRID``) as a float32 tensor on
    ``device``, made once: a copy from the host on every select would make
    the host wait for the device."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def rate_multipliers(action: torch.Tensor,
                     levels: tuple[float, ...] = RATE_LEVELS) -> torch.Tensor:
    """``[..., S, L]`` one-hot rate action -> ``[..., S]`` admission
    multipliers."""
    return action @ grid_tensor(levels, str(action.device))


def apply_rate_action(params: EnvParams, action: torch.Tensor,
                      levels: tuple[float, ...] = RATE_LEVELS) -> EnvParams:
    """Throttle each spout's offered load by its selected level (a pure
    EnvParams edit)."""
    return params._replace(
        base_rates=params.base_rates * rate_multipliers(action, levels))


def tune_settings(action: torch.Tensor,
                  grid: tuple[tuple[float, float], ...] = TUNE_GRID
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., K]`` one-hot tune action -> (acker_scale, batch_scale), each
    ``[...]``."""
    picked = action @ grid_tensor(grid, str(action.device))          # [..., 2]
    return picked[..., 0], picked[..., 1]


def apply_config_action(params: EnvParams, action: torch.Tensor,
                        grid: tuple[tuple[float, float], ...] = TUNE_GRID
                        ) -> EnvParams:
    """Apply one auto-tuning operating point per row (a pure EnvParams
    edit); ``tuple_bytes [..., N]`` takes its row's batch scale."""
    acker_scale, batch_scale = tune_settings(action, grid)
    return params._replace(acker_ms=params.acker_ms * acker_scale,
                           tuple_bytes=params.tuple_bytes * batch_scale[..., None])


def decode_state(env, s_vec: torch.Tensor,
                 params: EnvParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Invert ``SchedulingEnv.state_vector``: the flattened DNN state
    ``[..., N·M + S]`` back to (X ``[..., N, M]``, w ``[..., S]``).  The
    state vector is ``concat(X.reshape(-1), w / base_rates)``, so the
    cluster's params (``base_rates [S]`` or, per row, ``[..., S]``) pin the
    rate scale."""
    nm = env.N * env.M
    X = s_vec[..., :nm].reshape(*s_vec.shape[:-1], env.N, env.M)
    w = s_vec[..., nm:] * (params.base_rates + 1e-9)
    return X, w
