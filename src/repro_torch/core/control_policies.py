"""Non-placement control policies: rate control and auto-tuning agents.

Port of ``repro/core/control_policies.py``.  The serving control plane
dispatches three decision kinds (see ``core/spaces.py``); placement is
served by the learned DDPG agent, and these two deterministic policies
serve the other kinds through the same :class:`~repro_torch.core.api.Agent`
contract.  Both decide from ``(s_vec, env_params)`` alone (``env_state``
is ignored), which is the serving contract — see ``serve/control.py``.

* ``rate_control`` — a feedback throttle: from the normalized spout rates
  in the state vector it picks, per spout, the LARGEST admission level
  that keeps the admitted load under ``cfg.utilization_cap`` × the
  cluster's declared base rate.
* ``auto_tune`` — a model-grounded knob search: decodes (X, w) from the
  state vector, then evaluates every ``TUNE_GRID`` operating point under
  the CLUSTER'S OWN EnvParams through the queueing model and returns the
  argmin (the first of equal latencies, as ``jnp.argmin``).  The K points
  of R rows run as ONE pass over K·R rows (the reference unrolls K
  passes): the model's value of a row does not depend on the batch it
  rides in, so the latencies are the same, for 1/K of the kernels.

A select takes state vectors ``[..., state_dim]`` with any leading axes
(the plane's ``[1, n_slots]``) and returns one action per vector;
``auto_tune`` reads ``env_params`` as one EnvParams or as one stacked on
the flattened leading axes, a row per vector.  Both are registered
serving-only: their actions never reach ``env.step``."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import api
from repro_torch.device import resolve_device
from repro_torch.dsdps.actions import (RATE_LEVELS, TUNE_GRID, decode_state,
                                       grid_tensor)
from repro_torch.dsdps.env import SchedulingEnv
from repro_torch.dsdps.simulator import (EnvParams,
                                         average_tuple_time_from_params)


def _counter_init(gen, cfg, fleet: int, device, env_params=None):
    return torch.zeros(fleet, dtype=torch.int32, device=resolve_device(device))


def _noop_observe(cfg, state, s_vec, aux, reward, s_next):
    return state


def _noop_update(cfg, state, idx, gen):
    return state


def _tick(cfg, state):
    return state + 1


# --------------------------------------------------------------------------
# rate_control
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RateControlConfig:
    n_spouts: int
    levels: tuple[float, ...] = RATE_LEVELS     # ascending admission grid
    utilization_cap: float = 1.0                # max admitted / base rate


def _rate_select(cfg: RateControlConfig, state, s_vec, env_state, env_params,
                 explore, draws, gen):
    # the state vector's tail is w / base_rates (SchedulingEnv.state_vector)
    w_norm = s_vec[..., -cfg.n_spouts:]                          # [..., S]
    levels = grid_tensor(cfg.levels, str(s_vec.device))         # [L]
    admitted = levels * w_norm[..., None]                        # [..., S, L]
    fits = (admitted <= cfg.utilization_cap).to(torch.int32)
    # largest fitting level; all-overloaded spouts fall back to levels[0]
    idx = torch.clamp(fits.sum(-1) - 1, min=0)
    action = torch.nn.functional.one_hot(idx.long(), len(cfg.levels)).to(
        torch.float32)
    return action, idx


def rate_control_agent(cfg: RateControlConfig) -> api.Agent:
    return api.Agent(name="rate_control", cfg=cfg, init_fn=_counter_init,
                     select_fn=_rate_select, observe_fn=_noop_observe,
                     update_fn=_noop_update, tick_fn=_tick)


def rate_control_factory(env, **overrides) -> api.Agent:
    cfg = overrides.pop("cfg", None)
    if cfg is None:
        cfg = RateControlConfig(n_spouts=env.workload.num_spouts,
                                **overrides)
    return rate_control_agent(cfg)


# serving-only: rate actions are [S, L] level choices, not executor→machine
# placements — they never reach env.step (families=())
api.register_agent("rate_control", rate_control_factory, families=())


# --------------------------------------------------------------------------
# auto_tune
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AutoTuneConfig:
    env: SchedulingEnv          # compared by identity
    grid: tuple[tuple[float, float], ...] = TUNE_GRID


def _tune_select(cfg: AutoTuneConfig, state, s_vec, env_state, env_params,
                 explore, draws, gen):
    env = cfg.env
    p = env.default_params() if env_params is None else env_params
    K = len(cfg.grid)
    lead = s_vec.shape[:-1]
    rows = s_vec.reshape(-1, s_vec.shape[-1])                    # [R, D]
    R = rows.shape[0]
    X, w = decode_state(env, rows, p)                            # [R, N, M], [R, S]
    # rows k·R + r: grid point k under row r's own cluster params (fields
    # stacked on [R] repeat K times, one-copy fields stay one copy)
    pk = EnvParams(*(f.repeat(K, *(1,) * (f.dim() - 1)) if f.dim() > r.dim()
                     else f for f, r in zip(p, env.default_params())))
    scale = grid_tensor(cfg.grid, str(s_vec.device)).repeat_interleave(R, dim=0)
    pk = pk._replace(acker_ms=pk.acker_ms * scale[:, 0],
                     tuple_bytes=pk.tuple_bytes * scale[:, 1:])
    lats = average_tuple_time_from_params(
        X.repeat(K, 1, 1), w.repeat(K, 1), pk, env.params,
        env.cluster).reshape(K, R).T                             # [R, K]
    action = torch.nn.functional.one_hot(lats.argmin(-1), K).to(torch.float32)
    return action.reshape(*lead, K), lats.reshape(*lead, K)


def auto_tune_agent(cfg: AutoTuneConfig) -> api.Agent:
    return api.Agent(name="auto_tune", cfg=cfg, init_fn=_counter_init,
                     select_fn=_tune_select, observe_fn=_noop_observe,
                     update_fn=_noop_update, tick_fn=_tick)


def auto_tune_factory(env, **overrides) -> api.Agent:
    cfg = overrides.pop("cfg", None)
    if cfg is None:
        cfg = AutoTuneConfig(env=env, **overrides)
    return auto_tune_agent(cfg)


# serving-only, like rate_control: actions index the tuning grid
api.register_agent("auto_tune", auto_tune_factory, families=())
