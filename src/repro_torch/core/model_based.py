"""Model-based predictive scheduler — the state-of-the-art baseline [25]
(Li et al., "Performance modeling and predictive scheduling for distributed
stream data processing", IEEE TBD 2016).

Port of ``repro/core/model_based.py``.  [25] fits a regressor over
per-machine load and traffic features (the information its collectors see
at run time) and searches assignments under the model's guidance; here a
ridge regressor and a greedy move-based local search.  Its weakness, model
bias, is what the paper exploits.

Everything takes the scenario the baseline controls: ``params`` is one
EnvParams or, where the inputs carry a lane axis first, a lane-stacked
fleet of them, so every model-based lane profiles, fits and searches ITS
cluster.  The fit's random assignments and measurement draws may be passed
in.  Every product over executors or features is an elementwise product
and a sum, so a lane's values do not depend on the lanes beside it, and
``X @ Xᵀ`` of one-hot assignments is exact in any order.  The agent's
select scores all N·M single-executor moves of every lane in one batch
(``[F, N·M, N, M]``; at cq_large F=8 its ``[F, N·M, N, N]`` intermediates
are 320 MB each, two of them live at once)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import api
from repro_torch.device import resolve_device
from repro_torch.dsdps.env import N_MEASUREMENTS, SchedulingEnv
from repro_torch.dsdps.simulator import (EnvParams, lane_params,
                                         measured_latency_from_params)


def _lane_first(x: torch.Tensor, lead: int) -> torch.Tensor:
    """A stacked ``[F, *s]`` tensor as ``[F, 1, ..., 1, *s]`` with ``lead``
    axes before ``s``, so that it broadcasts against ``[F, ...]`` inputs."""
    return x.reshape(x.shape[0], *(1,) * (lead - 1), *x.shape[1:])


def _aligned(env: SchedulingEnv, params: EnvParams | None,
             lead: int) -> EnvParams:
    """``params`` (default: the env's) with every stacked field's lane axis
    on the first of ``lead`` batch axes."""
    ref = env.default_params()
    p = ref if params is None else params
    return EnvParams(*(_lane_first(x, lead) if x.dim() == r.dim() + 1 else x
                       for x, r in zip(p, ref)))


def features(env: SchedulingEnv, X: torch.Tensor, w: torch.Tensor,
             params: EnvParams | None = None) -> torch.Tensor:
    """Per-machine load & traffic statistics visible to [25]'s collectors,
    ``[..., 5M + 7]``, for one-hot assignments ``X [..., N, M]`` and rates
    ``w [..., S]`` (broadcast against ``X``'s batch axes), computed from the
    scenario ``params`` in effect (the env's nominal profile when None).

    Utilization is speed-adjusted: [25] measures per-machine delays, so its
    model knows which machines are slow, the lane's stragglers included.
    Service costs are the component-level profiled means: the per-executor
    reality deviates, which is the model bias the paper exploits."""
    p = _aligned(env, params, X.dim() - 2)
    spouts = env.params.structure(X.device).spout_ids
    w_full = w.new_zeros(*w.shape[:-1], env.N).index_copy(-1, spouts, w)
    lam = (p.flow_solve * w_full[..., None, :]).sum(-1)                # [..., N]
    demand = (X * (lam * p.nominal_service_ms / 1e3)[..., None]).sum(-2)  # [..., M]
    bytes_per_s = (lam[..., None] * p.routing) * p.tuple_bytes[..., None]
    # 1 - X Xᵀ as one temporary: at most two [..., N, N] tensors are live
    cross = bytes_per_s * (1.0 - X @ X.transpose(-1, -2))              # [..., N, N]
    out_load = (X * cross.sum(-1)[..., None]).sum(-2) / 1e8            # [..., M]
    in_load = (X * cross.sum(-2)[..., None]).sum(-2) / 1e8             # [..., M]
    util = demand / (env.cluster.cores_per_machine * p.speed)
    stats = torch.broadcast_tensors(
        util.amax(-1), util.mean(-1), out_load.amax(-1), in_load.amax(-1),
        cross.sum((-2, -1)) / 1e8, w.mean(-1) / 1e3, w.sum(-1) / 1e4)
    return torch.cat([util, util ** 2, util ** 3, out_load, in_load,
                      torch.stack(stats, -1)], -1)


def predict_latency(env: SchedulingEnv, theta: torch.Tensor, X: torch.Tensor,
                    w: torch.Tensor,
                    params: EnvParams | None = None) -> torch.Tensor:
    """The fitted model's end-to-end latency prediction ``[...]`` for
    assignments ``X [..., N, M]``; ``theta`` is ``[5M + 8]``, or ``[F, 5M +
    8]`` with the lane axis first like a stacked ``params``."""
    f = features(env, X, w, params)
    f = torch.cat([f, f.new_ones(*f.shape[:-1], 1)], -1)
    if theta.dim() == 2:
        theta = _lane_first(theta, X.dim() - 2)
    return (f * theta).sum(-1)


def fit_theta(env: SchedulingEnv, n_samples: int = 400,
              ridge_lambda: float = 1e-3, params: EnvParams | None = None,
              assignments: torch.Tensor | None = None,
              meas_z: torch.Tensor | None = None,
              gen: torch.Generator | None = None) -> torch.Tensor:
    """[25]'s offline profiling: measure ``n_samples`` random schedules of
    the cluster ``params`` describes (one scenario) and fit the ridge
    regressor; returns theta ``[5M + 8]``.  ``assignments [n, N]`` (the
    machine of each executor) and ``meas_z [n, 5]`` (standard-normal
    measurement noise) are the draws, from ``gen`` when not passed in."""
    p = env.default_params() if params is None else params
    dev = p.base_rates.device
    if assignments is None:
        assignments = torch.randint(0, env.M, (n_samples, env.N), generator=gen,
                                    device=dev)
    if meas_z is None:
        meas_z = torch.randn(n_samples, N_MEASUREMENTS, generator=gen,
                             device=dev)
    X = torch.nn.functional.one_hot(assignments.long(), env.M).to(torch.float32)
    w = p.base_rates
    y = measured_latency_from_params(X, w, p, env.params, env.cluster, meas_z)
    Fm = features(env, X, w, p)
    Fm = torch.cat([Fm, Fm.new_ones(Fm.shape[0], 1)], 1)
    A = Fm.T @ Fm + ridge_lambda * torch.eye(Fm.shape[1], device=dev)
    return torch.linalg.solve(A, Fm.T @ y)


@torch.no_grad()
def sweep_schedule_fleet(X0s: torch.Tensor, ws: torch.Tensor,
                         thetas: torch.Tensor, env: SchedulingEnv,
                         params: EnvParams | None = None,
                         sweeps: int = 3) -> torch.Tensor:
    """[25]'s model-guided greedy local search for every lane: ``sweeps``
    passes over the executors, each re-placing one executor at the model's
    argmin machine (the first, on ties, as ``jnp.argmin``).  ``X0s [F, N,
    M]``, ``ws [F, S]``, ``thetas [F, 5M + 8]``; ``params`` one scenario or
    lane-stacked.  N·sweeps dependent steps of M candidates each."""
    X = X0s.clone()
    m = X.shape[-1]
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    for _ in range(sweeps):
        for i in range(env.N):
            cand = X[:, None].repeat(1, m, 1, 1)                       # [F, M, N, M]
            cand[:, :, i] = eye
            preds = predict_latency(env, thetas, cand, ws[:, None], params)
            X[:, i] = eye[preds.argmin(-1)]
    return X


def sweep_schedule(X0: torch.Tensor, w: torch.Tensor, theta: torch.Tensor,
                   env: SchedulingEnv, params: EnvParams | None = None,
                   sweeps: int = 3) -> torch.Tensor:
    """The local search for one schedule ``X0 [N, M]`` under one scenario."""
    return sweep_schedule_fleet(X0[None], w[None], theta[None], env, params,
                                sweeps)[0]


@dataclasses.dataclass
class ModelBasedScheduler:
    env: SchedulingEnv
    ridge_lambda: float = 1e-3
    theta: torch.Tensor | None = None
    env_params: EnvParams | None = None   # the scenario the baseline controls

    def fit(self, gen: torch.Generator | None = None, n_samples: int = 400,
            assignments: torch.Tensor | None = None,
            meas_z: torch.Tensor | None = None) -> "ModelBasedScheduler":
        """Profile this scheduler's scenario and fit the ridge model."""
        self.theta = fit_theta(self.env, n_samples, self.ridge_lambda,
                               self.env_params, assignments, meas_z, gen)
        return self

    def predict(self, X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return predict_latency(self.env, self.theta, X, w, self.env_params)

    def schedule(self, w: torch.Tensor, X0: torch.Tensor | None = None,
                 sweeps: int = 3) -> torch.Tensor:
        X = self.env.round_robin_assignment() if X0 is None else X0
        return sweep_schedule(X, w, self.theta, self.env, self.env_params,
                              sweeps)


# --------------------------------------------------------------------------
# The Agent-interface adapter: [25] as a non-learning Agent.  ``init``
# profiles and fits every lane under the lane's scenario (the state IS the
# fitted theta, [F, 5M + 8]); ``select`` takes the best single-executor
# move under the model's prediction for the lane's scenario (the no-op
# moves are candidates, so "stay" is always allowed).
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelBasedAgentConfig:
    env: SchedulingEnv          # compared by identity
    fit_samples: int = 400
    ridge_lambda: float = 1e-3


def _agent_init(gen, cfg: ModelBasedAgentConfig, fleet: int, device,
                env_params=None):
    device = resolve_device(device)
    env = cfg.env
    ref = env.default_params()
    p = ref if env_params is None else env_params
    return torch.stack([
        fit_theta(env, cfg.fit_samples, cfg.ridge_lambda,
                  lane_params(p, ref, f), gen=gen)
        for f in range(fleet)]).to(device)


def _candidate_moves(X: torch.Tensor) -> torch.Tensor:
    """Every single-executor move of every lane: ``[F, N·M, N, M]``, move k
    placing executor ``k // M`` on machine ``k % M``."""
    n, m = X.shape[-2:]
    k = torch.arange(n * m, device=X.device)
    rows = torch.nn.functional.one_hot(k // m, n).bool()              # [K, N]
    cols = torch.nn.functional.one_hot(k % m, m).to(X.dtype)          # [K, M]
    return torch.where(rows[None, :, :, None], cols[None, :, None, :],
                       X[:, None])


@torch.no_grad()
def _agent_select(cfg: ModelBasedAgentConfig, theta, s_vec, env_state,
                  env_params, explore, draws, gen):
    cand = _candidate_moves(env_state.X)
    preds = predict_latency(cfg.env, theta, cand, env_state.w[:, None],
                            env_params)                               # [F, N·M]
    lanes = torch.arange(cand.shape[0], device=cand.device)
    return cand[lanes, preds.argmin(-1)], torch.zeros_like(lanes,
                                                           dtype=torch.float32)


def _agent_observe(cfg, theta, s_vec, aux, reward, s_next):
    return theta


def _agent_update(cfg, theta, idx, gen):
    return theta


def _agent_tick(cfg, theta):
    return theta


def as_agent(cfg: ModelBasedAgentConfig) -> api.Agent:
    return api.Agent(name="model_based", cfg=cfg, init_fn=_agent_init,
                     select_fn=_agent_select, observe_fn=_agent_observe,
                     update_fn=_agent_update, tick_fn=_agent_tick)


def agent_factory(env, **overrides) -> api.Agent:
    cfg = overrides.pop("cfg", None)
    if cfg is None:
        cfg = ModelBasedAgentConfig(env=env, **overrides)
    return as_agent(cfg)


# scheduling-only: the queueing model it profiles and searches is the DSDPS
# simulator's; it has no placement-env counterpart
api.register_agent("model_based", agent_factory, families=("scheduling",))
