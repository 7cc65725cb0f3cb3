"""Structural scheduling fleets: many DAG shapes in one fleet.

Port of ``repro/dsdps/structural.py``.  ``SchedulingEnv`` keeps its
topology's structure (reverse-topological schedule, component membership,
spout ids) as fixed index tensors, so every lane of a fleet shares one
graph.  This module moves the structure into the params instead:

  * :class:`Envelope`: the common padded size (executors, edges, spouts,
    components) a set of topologies is embedded into;
  * :class:`GraphEnvParams`: ``EnvParams`` plus masked structure fields
    (node mask, spout and component one-hots, edge index and weight
    arrays), so a lane-stacked fleet carries a different DAG per lane;
  * :class:`StructuralSchedulingEnv`: ``SchedulingEnv``'s API (``reset``,
    ``step``, ``state_vector``, ``evaluate``) with a padding-exact latency
    model: padded executors have zero service, zero flow and zero mask.

The completion-time recursion of ``simulator._latency_core`` becomes a
fixed-depth dense relaxation over ``R @ comp_onehot``, the same value on a
DAG (an executor of downstream height ``h`` is exact after ``h`` steps,
and heights stay below ``max_components``) with nothing that depends on
one topology.  Everything is batched over a leading lane axis ``[B]``;
each structure field is one copy or one per lane."""
from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dsdps import apps as _apps
from repro_torch.dsdps.cluster import ClusterSpec, PAPER_CLUSTER
from repro_torch.dsdps.env import N_MEASUREMENTS, EnvState, StepOut
from repro_torch.dsdps.simulator import _batched, _congestion, build_sim_params
from repro_torch.dsdps.topology import Topology
from repro_torch.dsdps.workload import NEVER_SHIFT, WorkloadProcess, step_rates


@dataclasses.dataclass(frozen=True)
class Envelope:
    """Common padded sizes a set of topologies is embedded into."""

    max_execs: int
    max_edges: int
    max_spouts: int
    max_components: int

    @classmethod
    def for_topologies(cls, topos: Sequence[Topology],
                       seed: int = 0) -> "Envelope":
        """The tight envelope over ``topos``."""
        return cls(
            max_execs=max(t.num_executors for t in topos),
            max_edges=max(int(np.count_nonzero(t.routing_matrix(seed)))
                          for t in topos),
            max_spouts=max(len(t.spout_executors) for t in topos),
            max_components=max(len(t.components) for t in topos))


class GraphEnvParams(NamedTuple):
    """``EnvParams`` plus per-lane topology structure, on one device.

    The first 13 fields are ``simulator.EnvParams``'s, so the scenario
    helpers (``with_straggler``, ``scale_rates``, ``perturb_service``, ...)
    and the stack/axes/lane helpers apply unchanged.  Padded entries are
    zeros; the edge index arrays pad with the sacrificial index ``N``."""

    routing: torch.Tensor             # [N, N] padded executor routing matrix
    flow_solve: torch.Tensor          # [N, N] (I - R^T)^-1, identity on padding
    service_ms: torch.Tensor          # [N] true CPU ms / tuple (0 on padding)
    nominal_service_ms: torch.Tensor  # [N]
    tuple_bytes: torch.Tensor         # [N]
    acker_ms: torch.Tensor            # scalar
    speed: torch.Tensor               # [M]
    noise_sigma: torch.Tensor         # scalar
    base_rates: torch.Tensor          # [S] padded with zeros
    rate_jitter: torch.Tensor         # scalar
    rate_revert: torch.Tensor         # scalar
    shift_epoch: torch.Tensor         # scalar int32
    shift_factor: torch.Tensor        # scalar
    node_mask: torch.Tensor           # [N] 1.0 on real executors
    spout_onehot: torch.Tensor        # [S, N] one-hot spout rows (0 on padding)
    comp_onehot: torch.Tensor         # [N, C] executor -> component (0 on padding)
    edge_src: torch.Tensor            # [E] int32 (padding = N, sacrificial)
    edge_dst: torch.Tensor            # [E] int32 (padding = N, sacrificial)
    edge_w: torch.Tensor              # [E] R[src, dst] (0 on padding)
    edge_mask: torch.Tensor           # [E]


@_batched
def graph_latency_ms(X: torch.Tensor, w: torch.Tensor, gp: GraphEnvParams,
                     cluster: ClusterSpec,
                     speed: torch.Tensor | None = None) -> torch.Tensor:
    """``_latency_core``'s queueing model with the structure taken from
    ``gp``: ``X [B, N, M]``, ``w [B, S]`` (or one ``[N, M]``, ``[S]``) →
    ``[B]`` ms.  Padding adds nothing (zero mask, service and flow); the
    reverse-topological recursion is ``max_components`` dense relaxation
    steps.  Every sum over executors is an elementwise product and a sum
    per row, so a lane's value does not depend on the lanes beside it."""
    mask = gp.node_mask
    X = X * mask[..., None]
    speed = gp.speed if speed is None else speed
    R = gp.routing
    comp = gp.comp_onehot                                             # [(B,) N, C]

    # 1. steady-state executor tuple rates (tuples/sec)
    w_full = (gp.spout_onehot * w[:, :, None]).sum(1)                 # [B, N]
    lam = (gp.flow_solve * w_full[:, None, :]).sum(-1)                # [B, N]

    same_mach = torch.bmm(X, X.transpose(1, 2))                       # [B, N, N]
    same_proc = same_mach
    edge_rate = lam[:, :, None] * R
    cross_proc = edge_rate * (1.0 - same_proc)
    cross_mach = edge_rate * (1.0 - same_mach)

    # 2. machine CPU contention (a padded executor's zero row demands nothing)
    c_ms = gp.service_ms
    ser_ms = cluster.ser_base_ms + gp.tuple_bytes * cluster.ser_ms_per_kb / 1024.0
    base_demand = (X * (lam * c_ms / 1e3)[:, :, None]).sum(1)         # [B, M]
    ser_out = (X * (cross_proc.sum(2) * ser_ms / 1e3)[:, :, None]).sum(1)
    ser_in = (X * ((cross_proc * ser_ms[..., None]).sum(1) / 1e3)[:, :, None]).sum(1)
    n_procs = (X.sum(1) > 0).to(torch.float32)
    proc_burn = n_procs * cluster.proc_overhead_cores
    presence = torch.clamp(torch.matmul(comp.transpose(-1, -2), X), 0.0, 1.0)
    n_comp = presence.sum(1)                                          # [B, M]
    mix = 1.0 + cluster.mix_penalty * torch.clamp(n_comp - 1.0, min=0.0)
    demand = (base_demand + ser_out + ser_in) * mix / speed + proc_burn
    g_m = _congestion(demand / cluster.cores_per_machine)             # [B, M]

    # 3. per-executor sojourn (0 on padding: c_ms = 0)
    inflate = (X * (g_m / speed)[:, None, :]).sum(2)                  # [B, N]
    s_eff = c_ms * inflate
    sojourn = s_eff * _congestion(lam * s_eff / 1e3)                  # [B, N]

    # 4. transfer delays with NIC contention
    bytes_per_s = cross_mach * gp.tuple_bytes[..., None]
    out_load = (X * bytes_per_s.sum(2)[:, :, None]).sum(1)
    in_load = (X * bytes_per_s.sum(1)[:, :, None]).sum(1)
    nic_g = _congestion(torch.maximum(out_load, in_load)
                        / (cluster.nic_bytes_per_ms * 1e3))
    x_nic = (X * nic_g[:, None, :]).sum(2)                            # [B, N]
    nic_factor = 0.5 * x_nic[:, :, None] + 0.5 * x_nic[:, None, :]
    wire_ms = gp.tuple_bytes[..., None] / cluster.nic_bytes_per_ms
    ser_path = 2.0 * ser_ms[..., None]
    d_edge = torch.where(
        same_proc > 0.5,
        cluster.local_base_ms,
        torch.where(same_mach > 0.5,
                    cluster.ipc_base_ms + ser_path,
                    cluster.net_base_ms + ser_path + wire_ms * nic_factor))

    # 5. completion times: fixed-depth relaxation of the reverse-topological
    # recursion.  mass[i, c] is executor i's routing mass into component c;
    # a branch's hop is the mass-weighted mean, the downstream cost the max
    # over the components branched to (ack joins)
    def by_component(A):                    # A @ comp, [(B,) N, N] -> [(B,) N, C]
        return (A[..., :, :, None] * comp[..., None, :, :]).sum(-2)

    mass = by_component(R)
    has = mass > 1e-9
    any_down = has.any(-1)
    mass_safe = torch.clamp(mass, min=1e-12)
    completion = sojourn
    for _ in range(comp.shape[-1]):
        hop = d_edge + completion[:, None, :]                         # [B, N, N]
        branch = by_component(R * hop) / mass_safe                    # [B, N, C]
        downstream = torch.where(has, branch, -torch.inf).amax(-1)
        downstream = torch.where(any_down, downstream, 0.0)
        completion = sojourn + downstream

    w_safe = torch.clamp(w, min=0.0)
    comp_sp = (gp.spout_onehot * completion[:, None, :]).sum(-1)      # [B, S]
    avg = (w_safe * comp_sp).sum(-1) / torch.clamp(w_safe.sum(-1), min=1e-9)
    return avg + gp.acker_ms


def measured_graph_latency_ms(X: torch.Tensor, w: torch.Tensor,
                              gp: GraphEnvParams, cluster: ClusterSpec,
                              z: torch.Tensor,
                              speed: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of ``z.shape[-1]`` lognormal-noised readings, ``z`` standard
    normal (``[n]``, or ``[B, n]`` for a batch), scaled by ``noise_sigma``."""
    base = graph_latency_ms(X, w, gp, cluster, speed=speed)
    return (base[..., None] * torch.exp(z * gp.noise_sigma[..., None])).mean(-1)


@dataclasses.dataclass(eq=False)
class StructuralSchedulingEnv:
    """One padded envelope over several topologies, on one device, with
    ``SchedulingEnv``'s API; lane ``f`` of a lane-stacked
    :class:`GraphEnvParams` fleet runs its own DAG."""

    family: ClassVar[str] = "scheduling"       # of core.api.ENV_FAMILIES
    structural: ClassVar[bool] = True          # a DAG of its own per lane
    topologies: Sequence[Topology]
    workloads: Sequence[WorkloadProcess] | None = None
    envelope: Envelope | None = None
    cluster: ClusterSpec = PAPER_CLUSTER
    noise_sigma: float = 0.03
    seed: int = 0
    device: str | torch.device | None = None   # CUDA unless asked otherwise

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.topologies = tuple(self.topologies)
        if not self.topologies:
            raise ValueError("StructuralSchedulingEnv needs >= 1 topology")
        if self.workloads is None:
            self.workloads = tuple(_apps.default_workload(t)
                                   for t in self.topologies)
        self.workloads = tuple(self.workloads)
        if len(self.workloads) != len(self.topologies):
            raise ValueError("workloads must align 1:1 with topologies")
        if self.envelope is None:
            self.envelope = Envelope.for_topologies(self.topologies,
                                                    seed=self.seed)
        self.N = self.envelope.max_execs
        self.M = self.cluster.num_machines
        # the first topology and its workload, padded: the default params
        self.topo = self.topologies[0]
        base = self.workloads[0]
        pad = self.envelope.max_spouts - len(base.base_rates)
        self.workload = dataclasses.replace(
            base, base_rates=tuple(base.base_rates) + (0.0,) * pad)
        self._default_params: GraphEnvParams | None = None

    # -- params ------------------------------------------------------------
    def params_for(self, topo: Topology,
                   workload: WorkloadProcess | None = None) -> GraphEnvParams:
        """``topo`` padded into this env's envelope.  Raises ``ValueError``
        naming the topology and the dimension that does not fit."""
        env_ = self.envelope
        gobs = topo.to_graph_obs(env_.max_execs, env_.max_edges, seed=self.seed)
        n_spouts = len(topo.spout_executors)
        n_comps = len(topo.components)
        if n_spouts > env_.max_spouts or n_comps > env_.max_components:
            raise ValueError(
                f"topology {topo.name} exceeds graph envelope: "
                f"{n_spouts} spouts / {n_comps} components vs "
                f"max_spouts={env_.max_spouts} / "
                f"max_components={env_.max_components}")
        if workload is None:
            workload = next(
                (wl for t, wl in zip(self.topologies, self.workloads)
                 if t is topo or t.name == topo.name),
                None) or _apps.default_workload(topo)
        if len(workload.base_rates) != n_spouts:
            raise ValueError(
                f"workload has {len(workload.base_rates)} spout rates, "
                f"topology {topo.name} has {n_spouts} spout executors")

        sim = build_sim_params(topo, seed=self.seed)
        n, nmax = topo.num_executors, env_.max_execs
        routing = np.zeros((nmax, nmax))
        routing[:n, :n] = sim.routing
        flow = np.eye(nmax)
        flow[:n, :n] = sim.flow_solve

        def pad_vec(x, size):
            out = np.zeros(size)
            out[: len(x)] = x
            return out

        spout_onehot = np.zeros((env_.max_spouts, nmax))
        spout_onehot[np.arange(n_spouts), sim.spout_ids] = 1.0
        comp_onehot = np.zeros((nmax, env_.max_components))
        comp_onehot[np.arange(n), sim.exec_component] = 1.0
        shift = workload.shift_epoch if workload.shift_epoch is not None \
            else NEVER_SHIFT
        f32 = functools.partial(torch.as_tensor, dtype=torch.float32,
                                device=self.device)
        i32 = functools.partial(torch.as_tensor, dtype=torch.int32,
                                device=self.device)
        return GraphEnvParams(
            routing=f32(routing),
            flow_solve=f32(flow),
            service_ms=f32(pad_vec(sim.service_ms, nmax)),
            nominal_service_ms=f32(pad_vec(sim.nominal_service_ms, nmax)),
            tuple_bytes=f32(pad_vec(sim.tuple_bytes, nmax)),
            acker_ms=f32(sim.acker_ms),
            speed=f32(self.cluster.speed_factors()),
            noise_sigma=f32(self.noise_sigma),
            base_rates=f32(pad_vec(workload.base_rates, env_.max_spouts)),
            rate_jitter=f32(workload.jitter),
            rate_revert=f32(workload.revert),
            shift_epoch=i32(shift),
            shift_factor=f32(workload.shift_factor),
            node_mask=f32(gobs.node_mask),
            spout_onehot=f32(spout_onehot),
            comp_onehot=f32(comp_onehot),
            edge_src=i32(gobs.edge_src),
            edge_dst=i32(gobs.edge_dst),
            edge_w=f32(gobs.edge_w),
            edge_mask=f32(gobs.edge_mask),
        )

    def default_params(self) -> GraphEnvParams:
        """The first topology under its workload (shared; treat as
        immutable)."""
        if self._default_params is None:
            self._default_params = self.params_for(self.topologies[0],
                                                   self.workloads[0])
        return self._default_params

    # -- helpers -----------------------------------------------------------
    def round_robin_assignment(self) -> torch.Tensor:
        """``[N, M]`` round-robin over the whole envelope (``reset`` and
        ``evaluate`` mask the padded rows)."""
        idx = np.arange(self.N) % self.M
        return torch.as_tensor(np.eye(self.M)[idx], dtype=torch.float32,
                               device=self.device)

    def state_vector(self, s: EnvState,
                     params: GraphEnvParams | None = None) -> torch.Tensor:
        """``[F, N·M + S]``; the padded spouts read exactly 0."""
        p = self.default_params() if params is None else params
        w_norm = s.w / (p.base_rates + 1e-9)
        return torch.cat([s.X.reshape(s.X.shape[0], -1), w_norm], dim=-1)

    @property
    def state_dim(self) -> int:
        return self.N * self.M + self.envelope.max_spouts

    @property
    def action_dim(self) -> int:
        return self.N * self.M

    # -- core API ----------------------------------------------------------
    def reset(self, fleet: int, params: GraphEnvParams | None = None,
              X0: torch.Tensor | None = None) -> EnvState:
        """``fleet`` lanes in the initial state (round-robin unless ``X0``),
        the padded rows zero, each lane under its own params."""
        p = self.default_params() if params is None else params
        X = self.round_robin_assignment() if X0 is None else X0
        X = torch.broadcast_to(X * p.node_mask[..., None],
                               (fleet, self.N, self.M)).clone()
        return EnvState(
            X=X,
            w=p.base_rates.expand(fleet, -1).clone(),
            epoch=torch.zeros(fleet, dtype=torch.int32, device=self.device),
            speed=p.speed.expand(fleet, -1).clone(),
        )

    def evaluate(self, X: torch.Tensor, w: torch.Tensor,
                 speed: torch.Tensor | None = None,
                 params: GraphEnvParams | None = None) -> torch.Tensor:
        """Noise-free steady-state latency (ms) of ``[N, M]`` or
        ``[B, N, M]`` assignments; X is masked here, so a round-robin over
        the whole envelope scores each lane's real executors."""
        p = self.default_params() if params is None else params
        return graph_latency_ms(X, w, p, self.cluster, speed=speed)

    def step(self, s: EnvState, action: torch.Tensor,
             params: GraphEnvParams | None = None,
             meas_z: torch.Tensor | None = None,
             rate_z: torch.Tensor | None = None,
             gen: torch.Generator | None = None) -> StepOut:
        """Deploy ``action [F, N, M]`` (padded rows cleared) and measure;
        ``moved`` counts real executors only.  Draws not passed in come
        from ``gen``."""
        p = self.default_params() if params is None else params
        F = action.shape[0]
        if meas_z is None:
            meas_z = torch.randn(F, N_MEASUREMENTS, generator=gen,
                                 device=self.device)
        if rate_z is None:
            rate_z = torch.randn(s.w.shape, generator=gen, device=self.device)
        action = action * p.node_mask[..., None]
        moved = (((action - s.X).abs().sum(-1) > 0)
                 & (p.node_mask > 0.5)).sum(-1)
        lat = measured_graph_latency_ms(action, s.w, p, self.cluster, meas_z,
                                        speed=s.speed)
        w_next = step_rates(s.w, s.epoch, p.base_rates, p.rate_jitter,
                            p.rate_revert, p.shift_epoch, p.shift_factor,
                            rate_z)
        nxt = EnvState(X=action, w=w_next, epoch=s.epoch + 1, speed=s.speed)
        return StepOut(state=nxt, reward=-lat, latency_ms=lat, moved=moved)
