"""Queueing-network latency model of a Storm-like DSDPS, in PyTorch.

Port of ``repro/dsdps/simulator.py``.  For a scheduling solution ``X``
(one-hot executor→machine) and spout workload ``w`` it computes the
steady-state average end-to-end tuple processing time via:

  1. flow solve           λ = (I − Rᵀ)⁻¹ w           (executor tuple rates)
  2. CPU contention       machine utilization → processor-sharing inflation
  3. per-executor sojourn M/M/1-PS:  T_i = s_i / (1 − ρ_i)
  4. network              per-edge transfer delay w/ 1 Gbps NIC contention
  5. end-to-end           reverse-topological completion-time recursion,
                          max over parallel downstream branches (ack joins)

Everything is batched over a leading axis of ``X`` (``[B, N, M]``; the
fleet axis, or any batch of candidate assignments).  ``SimParams`` is the
structural spec built in numpy float64 as the reference builds it;
``EnvParams`` is its numeric half as float32 tensors on a device.  A
scenario fleet stacks EnvParams on a leading lane axis (``[F, ...]``, see
:func:`stack_env_params`); the lane axis of every stacked field is the
batch axis of ``X``, field by field, so single-copy fields broadcast."""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.dsdps.cluster import ClusterSpec
from repro_torch.dsdps.topology import Topology
from repro_torch.dsdps.workload import NEVER_SHIFT, WorkloadProcess

# Utilization is soft-clipped below 1 to keep latencies finite.
_RHO_CAP = 0.97


def _congestion(rho: torch.Tensor) -> torch.Tensor:
    """1/(1-rho) with the soft cap rho_eff = 0.97·tanh(rho/0.97)."""
    return 1.0 / (1.0 - _RHO_CAP * torch.tanh(rho / _RHO_CAP))


class Structure(NamedTuple):
    """Index tensors of one topology on one device."""

    spout_ids: torch.Tensor        # [S] int64
    comp_onehot: torch.Tensor      # [N, C] float32
    # reverse-topological schedule: (source executor ids,
    # (downstream executor ids, ...)) for every component with successors
    rev_schedule: tuple[tuple[torch.Tensor, tuple[torch.Tensor, ...]], ...]


@dataclasses.dataclass
class SimParams:
    """Static per-topology arrays (numpy, float64 where numeric)."""

    routing: np.ndarray          # [N, N] executor routing matrix
    flow_solve: np.ndarray       # [N, N] (I - R^T)^-1
    service_ms: np.ndarray       # [N] TRUE CPU ms / tuple (with per-executor jitter)
    nominal_service_ms: np.ndarray  # [N] component-level mean
    tuple_bytes: np.ndarray      # [N]
    spout_ids: np.ndarray        # [S] executor ids of spouts
    exec_component: np.ndarray   # [N] component index per executor
    # reverse-topological component schedule: (component id, downstream ids)
    rev_schedule: tuple[tuple[int, tuple[int, ...]], ...]
    comp_members: tuple[tuple[int, ...], ...]   # executor ids per component
    acker_ms: float              # fixed ack/bookkeeping overhead
    _structures: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)

    def structure(self, device: torch.device) -> Structure:
        """The index tensors on ``device``, built once per device (the
        latency model runs every epoch; a fresh host→device copy of the
        indices each call would stall the stream)."""
        key = str(device)
        if key not in self._structures:
            def ids(x):
                return torch.as_tensor(np.asarray(x, np.int64), device=device)
            n_comp = int(self.exec_component.max()) + 1
            onehot = np.eye(n_comp, dtype=np.float32)[self.exec_component]
            rev = tuple(
                (ids(self.comp_members[ci]),
                 tuple(ids(self.comp_members[dc]) for dc in downs))
                for ci, downs in self.rev_schedule if downs)
            self._structures[key] = Structure(
                spout_ids=ids(self.spout_ids),
                comp_onehot=torch.as_tensor(onehot, device=device),
                rev_schedule=rev)
        return self._structures[key]

    def to_env_params(self, cluster: ClusterSpec, workload: WorkloadProcess,
                      device: str | torch.device,
                      noise_sigma: float = 0.03) -> "EnvParams":
        return to_env_params(self, cluster, workload, device, noise_sigma)


def build_sim_params(topo: Topology, seed: int = 0, acker_ms: float = 0.15,
                     exec_jitter_sigma: float = 0.25) -> SimParams:
    R = topo.routing_matrix(seed)
    n = topo.num_executors
    flow = np.linalg.inv(np.eye(n) - R.T)
    nominal = topo.service_demand_ms()
    rng = np.random.default_rng(seed + 104729)
    # per-executor true cost: lognormal around the component mean (mean-1
    # corrected) — the "many factors not captured by the model" of §1
    jitter = np.exp(rng.normal(-exec_jitter_sigma ** 2 / 2,
                               exec_jitter_sigma, size=n))
    true_ms = nominal * jitter
    nc = len(topo.components)
    down: list[set[int]] = [set() for _ in range(nc)]
    for e in topo.edges:
        down[topo._index[e.src]].add(topo._index[e.dst])
    rev = tuple(
        (ci, tuple(sorted(down[ci]))) for ci in reversed(topo.topo_order)
    )
    members = tuple(tuple(topo.executor_slice(c.name)) for c in topo.components)
    return SimParams(
        routing=R,
        flow_solve=flow,
        service_ms=true_ms,
        nominal_service_ms=nominal,
        tuple_bytes=topo.tuple_bytes(),
        spout_ids=topo.spout_executors,
        exec_component=topo.executor_component,
        rev_schedule=rev,
        comp_members=members,
        acker_ms=acker_ms,
    )


class EnvParams(NamedTuple):
    """Per-scenario numeric parameters, float32 tensors on one device
    (``shift_epoch`` is int32); a stacked field gains a leading ``[F]``."""

    routing: torch.Tensor             # [N, N] executor routing matrix
    flow_solve: torch.Tensor          # [N, N] (I - R^T)^-1
    service_ms: torch.Tensor          # [N] true CPU ms / tuple
    nominal_service_ms: torch.Tensor  # [N] component-level profiled mean
    tuple_bytes: torch.Tensor         # [N]
    acker_ms: torch.Tensor            # scalar ack/bookkeeping overhead
    speed: torch.Tensor               # [M] machine speed factors
    noise_sigma: torch.Tensor         # scalar measurement-noise sigma
    base_rates: torch.Tensor          # [S] spout base arrival rates
    rate_jitter: torch.Tensor         # scalar workload lognormal sigma
    rate_revert: torch.Tensor         # scalar mean-reversion strength
    shift_epoch: torch.Tensor         # scalar int32 (NEVER_SHIFT = disabled)
    shift_factor: torch.Tensor        # scalar Fig-12 step-change factor


def to_env_params(sim: SimParams, cluster: ClusterSpec,
                  workload: WorkloadProcess, device: str | torch.device,
                  noise_sigma: float = 0.03) -> EnvParams:
    """Bundle a built SimParams + cluster + workload spec into EnvParams."""
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=device)
    shift = workload.shift_epoch if workload.shift_epoch is not None \
        else NEVER_SHIFT
    return EnvParams(
        routing=f32(sim.routing),
        flow_solve=f32(sim.flow_solve),
        service_ms=f32(sim.service_ms),
        nominal_service_ms=f32(sim.nominal_service_ms),
        tuple_bytes=f32(sim.tuple_bytes),
        acker_ms=f32(sim.acker_ms),
        speed=f32(cluster.speed_factors()),
        noise_sigma=f32(noise_sigma),
        base_rates=f32(workload.base_rates),
        rate_jitter=f32(workload.jitter),
        rate_revert=f32(workload.revert),
        shift_epoch=torch.as_tensor(shift, dtype=torch.int32, device=device),
        shift_factor=f32(workload.shift_factor),
    )


def _f32_like(params: EnvParams, value) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32,
                           device=params.routing.device)


def with_noise_sigma(params: EnvParams, sigma) -> EnvParams:
    """Replace the measurement-noise level."""
    return params._replace(noise_sigma=_f32_like(params, sigma))


def with_speed(params: EnvParams, speed) -> EnvParams:
    """Replace the per-machine speed-factor vector."""
    return params._replace(speed=_f32_like(params, speed))


def with_straggler(params: EnvParams, machine: int, factor) -> EnvParams:
    """Slow machine ``machine`` to ``factor`` of nominal speed."""
    speed = params.speed.clone()
    speed[machine] = factor
    return params._replace(speed=speed)


def scale_rates(params: EnvParams, factor) -> EnvParams:
    """Scale every spout's base arrival rate (diurnal load, Fig-12 shifts)."""
    return params._replace(base_rates=params.base_rates * factor)


def _lognormal(x: torch.Tensor, z, sigma: float,
               gen: torch.Generator | None) -> torch.Tensor:
    """``x · exp(zσ − σ²/2)``, the mean-1 lognormal; ``z`` standard normal
    of ``x``'s shape, drawn from ``gen`` when not passed in."""
    if z is None:
        z = torch.randn(x.shape, generator=gen, device=x.device)
    z = torch.as_tensor(z, dtype=torch.float32, device=x.device)
    return x * torch.exp(z * sigma - 0.5 * sigma ** 2)


def perturb_service(params: EnvParams, z: torch.Tensor | None = None,
                    sigma: float = 0.15,
                    gen: torch.Generator | None = None) -> EnvParams:
    """Lognormal (mean-1 corrected) jitter on the TRUE per-executor service
    costs — samples 'the many factors not captured by the model' (§1).
    ``z [N]`` is the draw (the reference draws it from a key)."""
    return params._replace(
        service_ms=_lognormal(params.service_ms, z, sigma, gen))


def perturb_rates(params: EnvParams, z: torch.Tensor | None = None,
                  sigma: float = 0.15,
                  gen: torch.Generator | None = None) -> EnvParams:
    """Lognormal (mean-1 corrected) jitter on the spout base rates, from the
    draw ``z [S]``."""
    return params._replace(
        base_rates=_lognormal(params.base_rates, z, sigma, gen))


def stack_env_params(params_list, broadcast_invariant: bool = False
                     ) -> EnvParams:
    """Stack per-lane EnvParams (or ``structural.GraphEnvParams``, of one
    type throughout) on a leading ``[F]`` lane axis.

    With ``broadcast_invariant=True`` a field equal in every lane (routing,
    flow_solve, tuple_bytes, ... when no scenario perturbs them) stays ONE
    unstacked copy; the simulator broadcasts it over the lanes, with the
    same result as the full stack and without its F copies."""
    def stack_field(*xs):
        if broadcast_invariant and all(
                x is xs[0] or (x.shape == xs[0].shape and torch.equal(x, xs[0]))
                for x in xs[1:]):
            return xs[0]
        return torch.stack(xs)

    return type(params_list[0])(*(stack_field(*xs)
                                  for xs in zip(*params_list)))


def params_in_axes(params: EnvParams, ref: EnvParams) -> EnvParams | None:
    """Per field, whether ``params`` is stacked: True where the field has one
    more axis than in the single-scenario reference ``ref``.  None when no
    field is stacked (a plain single scenario)."""
    stacked = type(ref)(*(p.dim() == r.dim() + 1 for p, r in zip(params, ref)))
    return stacked if any(stacked) else None


def params_stacked(params: EnvParams, ref: EnvParams) -> bool:
    """True when any field of ``params`` carries the lane axis (a
    broadcast-invariant stack counts as stacked)."""
    return params_in_axes(params, ref) is not None


def lane_params(params: EnvParams, ref: EnvParams, lane: int) -> EnvParams:
    """Lane ``lane`` of a (possibly broadcast-invariant) stack as a single
    scenario; a single scenario passes through unchanged."""
    return type(ref)(*(p[lane] if p.dim() == r.dim() + 1 else p
                       for p, r in zip(params, ref)))


def params_lanes(params: EnvParams, ref: EnvParams) -> int | None:
    """The number of lanes of a stacked ``params`` (None for a single
    scenario); raises if its stacked fields disagree."""
    lanes = {p.shape[0] for p, r in zip(params, ref) if p.dim() == r.dim() + 1}
    if len(lanes) > 1:
        raise ValueError(f"stacked EnvParams fields disagree on the lane "
                         f"count: {sorted(lanes)}")
    return lanes.pop() if lanes else None


def _latency_core(
    X: torch.Tensor,             # [B, N, M]
    w: torch.Tensor,             # [B, S]
    *,
    routing: torch.Tensor,       # [N, N] or [B, N, N]
    flow_solve: torch.Tensor,    # [N, N] or [B, N, N]
    service_ms: torch.Tensor,    # [N] or [B, N]
    tuple_bytes: torch.Tensor,   # [N] or [B, N]
    acker_ms: torch.Tensor,      # scalar or [B]
    structure: Structure,
    cluster: ClusterSpec,
    speed: torch.Tensor,         # [M] or [B, M]
    same_proc: torch.Tensor | None,   # [N, N] or [B, N, N]
    n_procs: torch.Tensor | None,     # [M] or [B, M]
) -> torch.Tensor:
    """The queueing-model body, batched over the leading axis of ``X``;
    returns ``[B]`` latencies in ms.  Every numeric field is either one
    copy or one per batch row (a lane-stacked EnvParams); executor-indexed
    fields are read through ``[..., None]`` and ``[..., ids, :]`` so both
    forms broadcast alike.  Every product over executors is an elementwise
    product and a sum per batch row, so a row's value does not depend on
    the batch it rides in."""
    R = routing
    B, n, m = X.shape

    # 1. steady-state executor tuple rates (tuples/sec)
    w_full = X.new_zeros(B, n).index_copy(1, structure.spout_ids, w)
    lam = (flow_solve * w_full[:, None, :]).sum(-1)                   # [B, N]

    # edge tuple rates; machine / process locality masks
    same_mach = torch.bmm(X, X.transpose(1, 2))                       # [B, N, N]
    if same_proc is None:
        same_proc = same_mach
    else:
        same_proc = same_proc * same_mach   # same process => same machine
    edge_rate = lam[:, :, None] * R
    cross_proc = edge_rate * (1.0 - same_proc)       # pays ser/deser CPU
    cross_mach = edge_rate * (1.0 - same_mach)       # additionally uses NIC

    # 2. machine CPU contention: executor service + ser/deser CPU for every
    # inter-process tuple, on both ends
    c_ms = service_ms
    ser_ms = cluster.ser_base_ms + \
        tuple_bytes * cluster.ser_ms_per_kb / 1024.0                  # [(B,) N]
    base_demand = (X * (lam * c_ms / 1e3)[:, :, None]).sum(1)         # [B, M]
    ser_out = (X * (cross_proc.sum(2) * ser_ms / 1e3)[:, :, None]).sum(1)
    ser_in = (X * ((cross_proc * ser_ms[..., None]).sum(1) / 1e3)[:, :, None]).sum(1)
    if n_procs is None:
        # paper's schedulers: one worker process per (used) machine
        n_procs = (X.sum(1) > 0).to(torch.float32)
    proc_burn = n_procs * cluster.proc_overhead_cores
    # cross-component mixing interference (ClusterSpec.mix_penalty)
    presence = torch.clamp(torch.matmul(structure.comp_onehot.T, X), 0.0, 1.0)
    n_comp = presence.sum(1)                                          # [B, M]
    mix = 1.0 + cluster.mix_penalty * torch.clamp(n_comp - 1.0, min=0.0)
    demand = (base_demand + ser_out + ser_in) * mix / speed + proc_burn
    rho_cpu = demand / cluster.cores_per_machine
    g_m = _congestion(rho_cpu)                                        # [B, M]

    # 3. per-executor sojourn (service inflated by machine contention)
    inflate = (X * (g_m / speed)[:, None, :]).sum(2)                  # [B, N]
    s_eff = c_ms * inflate
    rho_exec = lam * s_eff / 1e3
    sojourn = s_eff * _congestion(rho_exec)                           # [B, N]

    # 4. transfer delays: in-process queue < IPC < network (NIC contention)
    bytes_per_s = cross_mach * tuple_bytes[..., None]
    out_load = (X * bytes_per_s.sum(2)[:, :, None]).sum(1)            # [B, M]
    in_load = (X * bytes_per_s.sum(1)[:, :, None]).sum(1)             # [B, M]
    nic_cap = cluster.nic_bytes_per_ms * 1e3                          # B/s
    rho_nic = torch.maximum(out_load, in_load) / nic_cap
    nic_g = _congestion(rho_nic)                                      # [B, M]
    x_nic = (X * nic_g[:, None, :]).sum(2)                            # [B, N]
    nic_factor = 0.5 * x_nic[:, :, None] + 0.5 * x_nic[:, None, :]
    wire_ms = tuple_bytes[..., None] / cluster.nic_bytes_per_ms
    # ser/deser is on the tuple's own path when crossing processes
    ser_path = 2.0 * ser_ms[..., None]
    d_edge = torch.where(
        same_proc > 0.5,
        cluster.local_base_ms,
        torch.where(
            same_mach > 0.5,
            cluster.ipc_base_ms + ser_path,
            cluster.net_base_ms + ser_path + wire_ms * nic_factor,
        ),
    )                                                                 # [B, N, N]

    # 5. completion-time recursion, reverse topological order over components
    completion = sojourn
    for src_ids, dst_groups in structure.rev_schedule:
        branch_costs = []
        for dst_ids in dst_groups:
            p = R[..., src_ids, :][..., dst_ids]                      # [(B,) s, d]
            p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-12)
            hop = d_edge[:, src_ids][:, :, dst_ids] + completion[:, dst_ids][:, None, :]
            branch_costs.append((p * hop).sum(2))                     # [B, s]
        downstream = functools.reduce(torch.maximum, branch_costs)
        completion = completion.index_add(1, src_ids, downstream)

    w_safe = torch.clamp(w, min=0.0)
    spout_completion = completion[:, structure.spout_ids]
    avg = (w_safe * spout_completion).sum(1) / torch.clamp(w_safe.sum(1), min=1e-9)
    return avg + acker_ms


def _batched(fn):
    """Let a latency function take one assignment ``[N, M]`` (with ``w``
    ``[S]``) as well as a batch ``[B, N, M]`` (with ``w`` ``[B, S]``)."""
    @functools.wraps(fn)
    def wrapper(X, w, *args, **kwargs):
        if X.dim() == 2:
            return fn(X[None], w[None], *args, **kwargs)[0]
        return fn(X, w.expand(X.shape[0], -1), *args, **kwargs)
    return wrapper


@_batched
def average_tuple_time_ms(
    X: torch.Tensor,
    w: torch.Tensor,
    params: SimParams,
    cluster: ClusterSpec,
    speed: torch.Tensor | None = None,
    same_proc: torch.Tensor | None = None,
    n_procs: torch.Tensor | None = None,
) -> torch.Tensor:
    """Average end-to-end tuple processing time in ms from a SimParams
    (arrays rounded to float32 on ``X``'s device, as the reference does).

    ``same_proc`` distinguishes worker processes within a machine (Storm's
    default EvenScheduler spreads executors over many processes); the
    paper's schedulers run one process per machine, the default here."""
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=X.device)
    speed = torch.ones(X.shape[-1], device=X.device) if speed is None else speed
    return _latency_core(
        X, w, routing=f32(params.routing), flow_solve=f32(params.flow_solve),
        service_ms=f32(params.service_ms), tuple_bytes=f32(params.tuple_bytes),
        acker_ms=f32(params.acker_ms), structure=params.structure(X.device),
        cluster=cluster, speed=speed, same_proc=same_proc, n_procs=n_procs)


@_batched
def average_tuple_time_from_params(
    X: torch.Tensor,
    w: torch.Tensor,
    env_params: EnvParams,
    sim: SimParams,
    cluster: ClusterSpec,
    speed: torch.Tensor | None = None,
    same_proc: torch.Tensor | None = None,
    n_procs: torch.Tensor | None = None,
) -> torch.Tensor:
    """``average_tuple_time_ms`` with the numeric arrays taken from an
    EnvParams (structure still from the SimParams)."""
    speed = env_params.speed if speed is None else speed
    return _latency_core(
        X, w, routing=env_params.routing, flow_solve=env_params.flow_solve,
        service_ms=env_params.service_ms, tuple_bytes=env_params.tuple_bytes,
        acker_ms=env_params.acker_ms, structure=sim.structure(X.device),
        cluster=cluster, speed=speed, same_proc=same_proc, n_procs=n_procs)


def measured_latency_from_params(
    X: torch.Tensor,
    w: torch.Tensor,
    env_params: EnvParams,
    sim: SimParams,
    cluster: ClusterSpec,
    z: torch.Tensor,
    speed: torch.Tensor | None = None,
    same_proc: torch.Tensor | None = None,
    n_procs: torch.Tensor | None = None,
) -> torch.Tensor:
    """Noisy measurement: mean of ``z.shape[-1]`` lognormal-perturbed
    readings, ``z`` standard normal (``[n]``, or ``[B, n]`` for a batch)
    scaled by ``env_params.noise_sigma`` (a scalar, or ``[B]`` stacked)."""
    base = average_tuple_time_from_params(X, w, env_params, sim, cluster,
                                          speed=speed, same_proc=same_proc,
                                          n_procs=n_procs)
    sigma = env_params.noise_sigma[..., None]
    return (base[..., None] * torch.exp(z * sigma)).mean(-1)


def measured_latency_ms(
    X: torch.Tensor,
    w: torch.Tensor,
    params: SimParams,
    cluster: ClusterSpec,
    speed: torch.Tensor | None = None,
    noise_sigma: float = 0.03,
    n_measurements: int = 5,
    same_proc: torch.Tensor | None = None,
    n_procs: torch.Tensor | None = None,
    z: torch.Tensor | None = None,
    gen: torch.Generator | None = None,
) -> torch.Tensor:
    """Noisy measurement: mean of ``n_measurements`` lognormal-perturbed
    readings (the framework averages 5 consecutive 10 s-spaced readings).
    ``z`` holds the standard-normal draws, ``[n_measurements]`` (``[B,
    n_measurements]`` for a batch); draws not passed in come from ``gen``
    on ``X``'s device."""
    base = average_tuple_time_ms(X, w, params, cluster, speed,
                                 same_proc=same_proc, n_procs=n_procs)
    if z is None:
        z = torch.randn((*base.shape, n_measurements), generator=gen,
                        device=X.device)
    return (base[..., None] * torch.exp(z * noise_sigma)).mean(-1)
