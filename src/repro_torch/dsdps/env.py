"""The scheduling environment: the decision-epoch loop of §3.1/§3.2.

State   s = (X, w)   — current assignment + spout arrival rates
Action  a ∈ {0,1}^{N×M}, row one-hot — new assignment
Reward  r = −(measured average tuple processing time, ms)

Port of ``repro/dsdps/env.py``.  Every EnvState leaf carries the fleet
axis ``[F]``.  ``params`` is one EnvParams shared by every lane, or a
lane-stacked scenario fleet (``simulator.stack_env_params``,
``dsdps.scenarios``) whose stacked fields lane ``f`` reads at ``[f]``.
``step`` takes its random draws — the measurement noise ``meas_z [F, 5]``
and the rate-walk noise ``rate_z [F, S]``, both standard normal — as
arguments, or draws them from a ``torch.Generator``."""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dsdps.cluster import ClusterSpec, PAPER_CLUSTER
from repro_torch.dsdps.simulator import (EnvParams, SimParams,
                                         average_tuple_time_from_params,
                                         build_sim_params,
                                         measured_latency_from_params)
from repro_torch.dsdps.topology import Topology
from repro_torch.dsdps.workload import WorkloadProcess, step_rates

N_MEASUREMENTS = 5   # the framework averages 5 consecutive readings


class EnvState(NamedTuple):
    X: torch.Tensor          # [F, N, M] one-hot assignment
    w: torch.Tensor          # [F, S] spout rates
    epoch: torch.Tensor      # [F] int32
    speed: torch.Tensor      # [F, M] machine speed factors


class StepOut(NamedTuple):
    state: EnvState
    reward: torch.Tensor     # [F]
    latency_ms: torch.Tensor  # [F]
    moved: torch.Tensor      # [F] number of re-assigned executors


@dataclasses.dataclass(eq=False)
class SchedulingEnv:
    """Static spec of one DSDPS control problem, on one device."""

    family: ClassVar[str] = "scheduling"       # of core.api.ENV_FAMILIES
    structural: ClassVar[bool] = False         # one topology for all lanes
    topo: Topology
    workload: WorkloadProcess
    cluster: ClusterSpec = PAPER_CLUSTER
    noise_sigma: float = 0.03
    seed: int = 0
    device: str | torch.device | None = None   # CUDA unless asked otherwise

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.params: SimParams = build_sim_params(self.topo, seed=self.seed)
        self.N = self.topo.num_executors
        self.M = self.cluster.num_machines
        self._default_params = self.params.to_env_params(
            self.cluster, self.workload, self.device, self.noise_sigma)

    def default_params(self) -> EnvParams:
        """The EnvParams of this spec's workload, cluster speeds and noise
        level (shared; treat as immutable)."""
        return self._default_params

    # -- helpers -----------------------------------------------------------
    def round_robin_assignment(self) -> torch.Tensor:
        idx = np.arange(self.N) % self.M
        return torch.as_tensor(np.eye(self.M)[idx], dtype=torch.float32,
                               device=self.device)

    def storm_default_assignment(self):
        """Storm EvenScheduler: executors round-robin over slots ordered
        machine-major — machine i%M, worker process (i//M) % slots.  Returns
        (X, same_proc mask, n_procs per machine)."""
        idx = np.arange(self.N) % self.M
        proc = (np.arange(self.N) // self.M) % self.cluster.slots_per_machine
        X = np.eye(self.M)[idx].astype(np.float32)
        same_proc = ((idx[:, None] == idx[None, :]) &
                     (proc[:, None] == proc[None, :])).astype(np.float32)
        n_procs = np.zeros(self.M, dtype=np.float32)
        for j in range(self.M):
            n_procs[j] = len(set(proc[idx == j]))
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in (X, same_proc, n_procs))

    def random_assignment(self, fleet: int,
                          gen: torch.Generator) -> torch.Tensor:
        """``[F, N, M]`` uniformly random one-hot assignments."""
        idx = torch.randint(0, self.M, (fleet, self.N), generator=gen,
                            device=self.device)
        return torch.nn.functional.one_hot(idx, self.M).to(torch.float32)

    def state_vector(self, s: EnvState,
                     params: EnvParams | None = None) -> torch.Tensor:
        """Flattened (X, w) fed to the DNNs — ``[F, N·M + S]``."""
        p = self.default_params() if params is None else params
        w_norm = s.w / (p.base_rates + 1e-9)
        return torch.cat([s.X.reshape(s.X.shape[0], -1), w_norm], dim=-1)

    @property
    def state_dim(self) -> int:
        return self.N * self.M + self.workload.num_spouts

    @property
    def action_dim(self) -> int:
        return self.N * self.M

    # -- core API ----------------------------------------------------------
    def reset(self, fleet: int, params: EnvParams | None = None,
              X0: torch.Tensor | None = None) -> EnvState:
        """``fleet`` lanes in the initial state (round-robin unless ``X0``),
        each lane's rates and speeds from its own scenario."""
        p = self.default_params() if params is None else params
        X = self.round_robin_assignment() if X0 is None else X0
        return EnvState(
            X=X.expand(fleet, self.N, self.M).clone(),
            w=p.base_rates.expand(fleet, -1).clone(),
            epoch=torch.zeros(fleet, dtype=torch.int32, device=self.device),
            speed=p.speed.expand(fleet, -1).clone(),
        )

    def evaluate(self, X: torch.Tensor, w: torch.Tensor,
                 speed: torch.Tensor | None = None,
                 same_proc: torch.Tensor | None = None,
                 n_procs: torch.Tensor | None = None,
                 params: EnvParams | None = None) -> torch.Tensor:
        """Noise-free steady-state latency (ms) of ``[N, M]`` or
        ``[B, N, M]`` assignments."""
        p = self.default_params() if params is None else params
        return average_tuple_time_from_params(
            X, w, p, self.params, self.cluster, speed=speed,
            same_proc=same_proc, n_procs=n_procs)

    def step(self, s: EnvState, action: torch.Tensor,
             params: EnvParams | None = None,
             meas_z: torch.Tensor | None = None,
             rate_z: torch.Tensor | None = None,
             gen: torch.Generator | None = None) -> StepOut:
        """Deploy ``action`` ``[F, N, M]`` and measure.  Draws not passed in
        come from ``gen``."""
        p = self.default_params() if params is None else params
        F = action.shape[0]
        if meas_z is None:
            meas_z = torch.randn(F, N_MEASUREMENTS, generator=gen,
                                 device=self.device)
        if rate_z is None:
            rate_z = torch.randn(s.w.shape, generator=gen, device=self.device)
        moved = ((action - s.X).abs().sum(-1) > 0).sum(-1)
        lat = measured_latency_from_params(
            action, s.w, p, self.params, self.cluster, meas_z, speed=s.speed)
        w_next = step_rates(s.w, s.epoch, p.base_rates, p.rate_jitter,
                            p.rate_revert, p.shift_epoch, p.shift_factor,
                            rate_z)
        nxt = EnvState(X=action, w=w_next, epoch=s.epoch + 1, speed=s.speed)
        return StepOut(state=nxt, reward=-lat, latency_ms=lat, moved=moved)
