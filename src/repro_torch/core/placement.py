"""The paper's technique on another placement problem: MoE experts on the
devices of an accelerator slice.

Port of ``repro/core/placement.py``.  Placing N experts on M devices to
minimise the step time under skewed routing and stragglers has the shape
of the paper's problem (N executors on M machines, lowest tuple time), so
every agent of the DSDPS env runs on it unchanged:

  state   (X, w):  expert→device assignment + per-expert token load
  action  one-hot [N_experts, M_devices]
  reward  −(estimated step time) from a roofline-style cost model: the
          slowest device's compute (load imbalance) against its share of
          the all-to-all over a ring interconnect.

The cost model's hardware constants are the reference's own
(:data:`PEAK_FLOPS`, :data:`ICI_BW`): they describe the simulated slice,
not the card the port runs on.

Every tensor carries the fleet axis ``[F]``.  ``params`` is one
:class:`PlacementParams` or a lane-stacked fleet of them
(``build_scenario``).  ``step`` takes its random draws — the step-time
noise ``meas_z [F]`` and the load drift ``rate_z [F, E]``, both standard
normal — as arguments, or draws them from a ``torch.Generator``; so do
``perturb_skew`` (``z [E]``) and the scenario fleets that use it
(``skew_z [F, E]``)."""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dsdps.simulator import stack_env_params

PEAK_FLOPS = 197e12          # bf16 per device of the simulated slice
ICI_BW = 50e9                # bytes/s per interconnect link


class PlacementState(NamedTuple):
    X: torch.Tensor          # [F, E, D] expert -> device
    w: torch.Tensor          # [F, E] tokens routed to each expert this interval
    epoch: torch.Tensor      # [F] int32
    speed: torch.Tensor      # [F, D] device speed factors (straggler model)

    @property
    def fleet(self) -> int:
        return self.X.shape[0]


class PlacementStep(NamedTuple):
    state: PlacementState
    reward: torch.Tensor      # [F]
    latency_ms: torch.Tensor  # [F] estimated step time (ms)
    moved: torch.Tensor       # [F] number of re-placed experts


class PlacementParams(NamedTuple):
    """Scenario parameters of the placement env, one scenario or stacked
    on a leading lane axis."""

    base_load: torch.Tensor    # [E] mean tokens routed to each expert
    speed: torch.Tensor        # [D] device speed factors
    noise_sigma: torch.Tensor  # scalar step-time measurement noise
    load_jitter: torch.Tensor  # scalar per-epoch routing-drift sigma


@dataclasses.dataclass(eq=False)
class ExpertPlacementEnv:
    """MoE expert placement on a ring interconnect, on one device."""

    family: ClassVar[str] = "placement"        # of core.api.ENV_FAMILIES
    structural: ClassVar[bool] = False
    num_experts: int
    num_devices: int
    flops_per_token: float            # 2 * d_model * d_ff * 3 (gated FFN)
    bytes_per_token: int              # activation bytes moved per routed token
    tokens_per_step: int              # total routed tokens per step
    skew: float = 1.0                 # Zipf exponent of expert popularity
    jitter: float = 0.10              # per-epoch load jitter
    seed: int = 0
    noise_sigma: float = 0.01
    device: str | torch.device | None = None   # CUDA unless asked otherwise

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        # the reference's numpy draw, rounded to float32 as jnp.asarray does
        rng = np.random.default_rng(self.seed)
        pop = np.arange(1, self.num_experts + 1, dtype=np.float64) ** (-self.skew)
        self._base_load = torch.tensor(
            rng.permutation(pop / pop.sum()) * self.tokens_per_step,
            dtype=torch.float32, device=self.device)
        self.N, self.M = self.num_experts, self.num_devices
        self._default_params = PlacementParams(
            base_load=self._base_load,
            speed=torch.ones(self.M, device=self.device),
            noise_sigma=torch.tensor(self.noise_sigma, dtype=torch.float32,
                                     device=self.device),
            load_jitter=torch.tensor(self.jitter, dtype=torch.float32,
                                     device=self.device))

    def default_params(self) -> PlacementParams:
        """The spec's load, unit speeds and noise levels (shared; treat as
        immutable)."""
        return self._default_params

    @property
    def state_dim(self) -> int:
        return self.N * self.M + self.N

    @property
    def action_dim(self) -> int:
        return self.N * self.M

    def round_robin_assignment(self) -> torch.Tensor:
        idx = np.arange(self.N) % self.M
        return torch.as_tensor(np.eye(self.M)[idx], dtype=torch.float32,
                               device=self.device)

    def random_assignment(self, fleet: int,
                          gen: torch.Generator) -> torch.Tensor:
        """``[F, E, D]`` uniformly random one-hot assignments."""
        idx = torch.randint(0, self.M, (fleet, self.N), generator=gen,
                            device=self.device)
        return torch.nn.functional.one_hot(idx, self.M).to(torch.float32)

    def state_vector(self, s: PlacementState,
                     params: PlacementParams | None = None) -> torch.Tensor:
        """Flattened (X, w / base_load) fed to the nets — ``[F, E·D + E]``."""
        p = self.default_params() if params is None else params
        w_norm = s.w / (p.base_load + 1e-9)
        return torch.cat([s.X.reshape(s.X.shape[0], -1), w_norm], dim=-1)

    def reset(self, fleet: int, params: PlacementParams | None = None,
              X0: torch.Tensor | None = None) -> PlacementState:
        """``fleet`` lanes in the initial state (round-robin unless ``X0``),
        each lane's load and speeds from its own scenario."""
        p = self.default_params() if params is None else params
        X = self.round_robin_assignment() if X0 is None else X0
        return PlacementState(
            X=X.expand(fleet, self.N, self.M).clone(),
            w=p.base_load.expand(fleet, -1).clone(),
            epoch=torch.zeros(fleet, dtype=torch.int32, device=self.device),
            speed=p.speed.expand(fleet, -1).clone())

    # -- cost model --------------------------------------------------------
    def step_time_ms(self, X: torch.Tensor, w: torch.Tensor,
                     speed: torch.Tensor | None = None) -> torch.Tensor:
        """Estimated step time (ms) of ``[E, D]`` or ``[B, E, D]``
        assignments under loads ``w`` (``[E]`` or ``[B, E]``); ``speed``
        is ``[D]`` or ``[B, D]``.  The slowest device of each row sets it:
        the max runs over a row's devices, never across rows."""
        speed = torch.ones(self.M, device=X.device) if speed is None else speed
        # compute: experts run one after another on their device
        dev_tokens = (X * w[..., None]).sum(-2)                       # [.., D]
        t_comp = dev_tokens * self.flops_per_token / (PEAK_FLOPS * speed)
        # comm: tokens enter and leave each expert's device uniformly from
        # all devices; a ring -> per-link bytes at the average hop distance
        cross = (w[..., None] * X * (1.0 - 1.0 / self.M)).sum(-2)     # [.., D]
        bytes_dev = 2.0 * cross * self.bytes_per_token                # in + out
        avg_hops = self.M / 4.0
        t_comm = bytes_dev * avg_hops / (ICI_BW * 2.0)                # 2 links/dir
        return 1e3 * (torch.maximum(t_comp, t_comm)
                      + 0.25 * torch.minimum(t_comp, t_comm)).amax(-1)

    def evaluate(self, X: torch.Tensor, w: torch.Tensor,
                 speed: torch.Tensor | None = None,
                 params: PlacementParams | None = None) -> torch.Tensor:
        """Noise-free step time (ms); ``params`` gives the speeds when
        ``speed`` is not passed."""
        if speed is None and params is not None:
            speed = params.speed
        return self.step_time_ms(X, w, speed)

    def step(self, s: PlacementState, action: torch.Tensor,
             params: PlacementParams | None = None,
             meas_z: torch.Tensor | None = None,
             rate_z: torch.Tensor | None = None,
             gen: torch.Generator | None = None) -> PlacementStep:
        """Deploy ``action`` ``[F, E, D]`` and measure.  Draws not passed in
        come from ``gen``: ``meas_z [F]`` first, then ``rate_z [F, E]``."""
        p = self.default_params() if params is None else params
        F = action.shape[0]
        if meas_z is None:
            meas_z = torch.randn(F, generator=gen, device=self.device)
        if rate_z is None:
            rate_z = torch.randn(s.w.shape, generator=gen, device=self.device)
        moved = ((action - s.X).abs().sum(-1) > 0).sum(-1)
        t = self.step_time_ms(action, s.w, s.speed)
        t = t * torch.exp(meas_z * p.noise_sigma)
        # expert popularity drifts (the routing distribution shifts)
        z = rate_z * p.load_jitter[..., None]
        w_next = s.w + 0.3 * (p.base_load * torch.exp(z) - s.w)
        nxt = PlacementState(X=action, w=w_next, epoch=s.epoch + 1,
                             speed=s.speed)
        return PlacementStep(state=nxt, reward=-t, latency_ms=t, moved=moved)

    def with_straggler(self, s: PlacementState, device: int,
                       factor: float) -> PlacementState:
        """Every lane's device ``device`` slowed to ``factor``."""
        speed = s.speed.clone()
        speed[:, device] = factor
        return s._replace(speed=speed)


# --------------------------------------------------------------------------
# Scenario helpers and named fleets: each fleet function returns one
# PlacementParams per lane; build_scenario stacks them.
# --------------------------------------------------------------------------
def with_device_straggler(params: PlacementParams, device: int,
                          factor) -> PlacementParams:
    """Slow device ``device`` to ``factor`` of nominal speed."""
    speed = params.speed.clone()
    speed[device] = factor
    return params._replace(speed=speed)


def scale_load(params: PlacementParams, factor) -> PlacementParams:
    """Scale every expert's mean routed-token load (traffic surge)."""
    return params._replace(base_load=params.base_load * factor)


def with_placement_noise(params: PlacementParams, sigma) -> PlacementParams:
    """Replace the step-time measurement-noise level."""
    return params._replace(noise_sigma=torch.tensor(
        sigma, dtype=torch.float32, device=params.noise_sigma.device))


def perturb_skew(params: PlacementParams, z: torch.Tensor | None = None,
                 sigma: float = 0.3,
                 gen: torch.Generator | None = None) -> PlacementParams:
    """Lognormal (mean-1 corrected) jitter on per-expert popularity: ``z
    [E]`` standard normal, from ``gen`` when not passed."""
    if z is None:
        z = torch.randn(params.base_load.shape, generator=gen,
                        device=params.base_load.device)
    mult = torch.exp(z * sigma - 0.5 * sigma ** 2)
    return params._replace(base_load=params.base_load * mult)


def _skew_draws(env, fleet: int, seed: int, skew_z):
    """``skew_z [fleet, E]``, or a generator's on the env's device seeded
    with ``seed`` (the reference folds the lane into ``PRNGKey(seed)``)."""
    if skew_z is not None:
        return skew_z
    gen = torch.Generator(device=env.device).manual_seed(seed)
    return torch.randn(fleet, env.N, generator=gen, device=env.device)


def _pl_uniform(env, fleet: int) -> list:
    return [env.default_params()] * fleet


def _pl_one_slow_device(env, fleet: int, factor: float = 0.5) -> list:
    p = env.default_params()
    return [with_device_straggler(p, i % env.M, factor) for i in range(fleet)]


def _pl_skewed_routing(env, fleet: int, sigma: float = 0.3, seed: int = 0,
                       skew_z: torch.Tensor | None = None) -> list:
    p = env.default_params()
    z = _skew_draws(env, fleet, seed, skew_z)
    return [perturb_skew(p, z[i], sigma) for i in range(fleet)]


def _pl_traffic_surge(env, fleet: int, amplitude: float = 0.5) -> list:
    p = env.default_params()
    return [scale_load(p, 1.0 + amplitude * i / max(fleet - 1, 1))
            for i in range(fleet)]


def _pl_mixed(env, fleet: int, seed: int = 0,
              skew_z: torch.Tensor | None = None) -> list:
    p = env.default_params()
    z = _skew_draws(env, fleet, seed, skew_z)
    lanes = []
    for i in range(fleet):
        lane = perturb_skew(p, z[i], 0.2)
        kind = i % 3
        if kind == 1:
            lane = with_device_straggler(lane, i % env.M, 0.5)
        elif kind == 2:
            lane = with_placement_noise(scale_load(lane, 1.3), 0.05)
        lanes.append(lane)
    return lanes


PLACEMENT_SCENARIOS = {
    "uniform": _pl_uniform,
    "one_slow_device": _pl_one_slow_device,
    "skewed_routing": _pl_skewed_routing,
    "traffic_surge": _pl_traffic_surge,
    "mixed": _pl_mixed,
}


def build_scenario(name: str, env: ExpertPlacementEnv, fleet: int,
                   broadcast_invariant: bool = False,
                   **kwargs) -> PlacementParams:
    """Stacked PlacementParams for a named placement scenario fleet;
    ``kwargs`` go to the fleet's function (``factor=``, ``sigma=``, ``seed=``,
    ``skew_z=``, ...)."""
    try:
        lanes = PLACEMENT_SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown placement scenario {name!r}; "
                       f"known: {sorted(PLACEMENT_SCENARIOS)}") from None
    return stack_env_params(lanes(env, fleet, **kwargs),
                            broadcast_invariant=broadcast_invariant)


def jamba_placement_env(num_devices: int = 16,
                        device: str | torch.device | None = None
                        ) -> ExpertPlacementEnv:
    """Jamba-1.5-large's 16 experts on a 16-way model axis: d_model 8192,
    d_ff 24576, 65,536 routed tokens a step (4096 × 8 microbatch tokens,
    top-2), Zipf skew 0.9.  Constants only: no weights."""
    d_model, d_ff = 8192, 24576
    return ExpertPlacementEnv(
        num_experts=16,
        num_devices=num_devices,
        flops_per_token=2.0 * 3 * d_model * d_ff,
        bytes_per_token=2 * d_model,
        tokens_per_step=4096 * 8 * 2,
        skew=0.9,
        device=device,
    )
