"""Serving control plane: batched low-latency decisions for many clusters.

Port of ``repro/serve/control.py``.  The paper's end state is *online
control* — a trained policy continuously issuing scheduling decisions to
live DSDPS clusters, where decision latency is part of the control loop.
A :class:`ControlPlane` accepts concurrent per-cluster
:class:`DecisionRequest`\\ s (state vector + cluster id), answers every
active request in ONE batched ``Agent.select`` call, and hands the
decisions back.

The scheduler is the reference's, unchanged: a FIFO queue feeds a fixed
pool of batch slots, each engine step serves every active slot in one
dispatch, and — because a scheduling decision completes in a single step
— every served slot retires and is recycled on the next admission pass.
The batch width is therefore ``min(n_slots, backlog)`` every step, and
queueing delay (not just compute) shows up in the latency percentiles,
measured from submit to decision.

Heterogeneous clusters share one select: each registered cluster's
:class:`~repro_torch.dsdps.simulator.EnvParams` joins a
``stack_env_params(..., broadcast_invariant=True)`` stack, each step
gathers every slot's cluster row from the stacked fields with an
``[n_slots]`` index tensor (``params_in_axes`` says which fields are
stacked), and invariant fields (routing, flow_solve, ...) stay one copy.
The plane holds ONE agent state, a fleet of one (``F = 1``), and hands
the select its slots as rows under that lane: the state vectors go in as
``[1, n_slots, state_dim]`` and the policy's weights are not copied per
slot.  A step uploads the state vectors and indices (from pinned host
buffers on CUDA, without a wait) and makes exactly one device-to-host
pull, the actions' ``.cpu()``, which is also its only wait on the device.

The serving contract is ``select(s_vec, cluster params)``: the decision
policies it dispatches (``ddpg`` placement, ``rate_control``,
``auto_tune`` — see ``core/spaces.py``) decide from the state vector and
the cluster's parameters alone.  Agents whose select needs a live
``EnvState`` (dqn's incremental move, model_based's search) are not
servable through this path.

The reference jits the batched select once per cluster-stack layout and
donates the per-step input buffers; eager PyTorch has neither a trace
cache nor donation, so neither has a counterpart here, nor has the
reference's compile-once assertion around a plane's program.
``serve_control --guards`` counts a step's waits on the device instead
(``diagnostics.guards(transfer="log")``)."""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import spaces
from repro_torch.core.api import Agent
from repro_torch.dsdps.simulator import (EnvParams, params_in_axes,
                                         stack_env_params)


# --------------------------------------------------------------------------
# Request / decision types
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DecisionRequest:
    """One cluster's ask for a decision.

    Submit with ``rid``/``cluster``/``s_vec`` (and ``kind`` when routing
    through a multi-kind :class:`ControlService`); the plane fills
    ``action`` / ``latency_ms`` / ``done`` when the decision is served.
    ``latency_ms`` is submit→decision wall time — queueing included."""

    rid: int
    cluster: str
    s_vec: Any                       # [state_dim] float32
    kind: str | None = None
    action: Any = None               # np.ndarray once decided
    latency_ms: float = 0.0
    submitted_at: float = 0.0
    done: bool = False


def nearest_rank_percentile(samples, q: float) -> float:
    """Deterministic nearest-rank percentile (no interpolation): the
    smallest sample with at least q% of the trace at or below it."""
    if not len(samples):
        raise ValueError("percentile of an empty trace")
    xs = sorted(float(x) for x in samples)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def latency_stats(samples_ms) -> dict:
    """p50/p99/mean over a latency trace (ms) — the serve_bench schema."""
    samples = [float(x) for x in samples_ms]
    return {
        "n": len(samples),
        "p50_ms": nearest_rank_percentile(samples, 50.0),
        "p99_ms": nearest_rank_percentile(samples, 99.0),
        "mean_ms": sum(samples) / len(samples),
    }


# --------------------------------------------------------------------------
# The selects
# --------------------------------------------------------------------------
def gather_clusters(stacked: EnvParams, axes: EnvParams | None,
                    lane_idx: torch.Tensor) -> EnvParams:
    """Each slot's cluster row: the stacked fields indexed by ``lane_idx
    [n_slots]``, invariant fields passed through as one copy (``axes`` from
    :func:`params_in_axes`; None = every cluster identical, passed whole)."""
    if axes is None:
        return stacked
    return EnvParams(*(p.index_select(0, lane_idx) if stacked_field else p
                       for p, stacked_field in zip(stacked, axes)))


@torch.no_grad()
def single_select(agent: Agent, state, s_vec, env_params=None,
                  explore: bool = False,
                  gen: torch.Generator | None = None) -> torch.Tensor:
    """One request's select — the sequential baseline the batched plane is
    compared with.  ``s_vec [state_dim]`` and one cluster's EnvParams →
    its action, on the state's device."""
    device = _device_of(state)
    s = torch.as_tensor(np.asarray(s_vec, np.float32), device=device)
    action, _ = agent.select_fn(agent.cfg, state, s[None, None], None,
                                env_params, explore, None, gen)
    return action[0, 0]


@torch.no_grad()
def batched_select(agent: Agent, state, s_mat: torch.Tensor,
                   lane_idx: torch.Tensor, stacked: EnvParams,
                   axes: EnvParams | None, explore: bool = False,
                   gen: torch.Generator | None = None) -> torch.Tensor:
    """Every slot's select as ONE call: ``s_mat [n_slots, state_dim]`` rows
    under the agent's single lane, each with its cluster's params gathered
    by ``lane_idx [n_slots]`` → actions ``[n_slots, *action_shape]``."""
    lanes = gather_clusters(stacked, axes, lane_idx)
    action, _ = agent.select_fn(agent.cfg, state, s_mat[None], None, lanes,
                                explore, None, gen)
    return action[0]


def _device_of(state) -> torch.device:
    """The device an agent state lives on (a tensor, or a state whose
    ``epoch`` is one)."""
    return (state if isinstance(state, torch.Tensor) else state.epoch).device


# --------------------------------------------------------------------------
# The control plane
# --------------------------------------------------------------------------
class ControlPlane:
    """Host-side slot scheduler around one batched select.

    One plane serves ONE decision kind (a ``core.spaces`` action space)
    with one agent + agent state (a fleet of one) shared across clusters;
    clusters differ by their registered EnvParams."""

    def __init__(self, env, agent: Agent, agent_state,
                 kind: str = "placement", n_slots: int = 8,
                 explore: bool = False):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.space = spaces.action_space(kind)     # unknown kind -> KeyError
        self.kind = kind
        self.env = env
        self.agent = agent
        self.state = agent_state
        self.n_slots = int(n_slots)
        self.explore = bool(explore)
        self.device = _device_of(agent_state)
        self.queue: deque[DecisionRequest] = deque()
        self.slots: list[Optional[DecisionRequest]] = [None] * self.n_slots
        self._ref = env.default_params()
        self._clusters: dict[str, int] = {}
        self._params_list: list[Any] = []
        self._stacked = None
        self._axes = None
        self._finished: list[DecisionRequest] = []
        self._latencies_ms: list[float] = []
        self.steps = 0                             # steps that served a slot
        # per-step upload buffers, pinned on CUDA so the copies need no wait
        pin = self.device.type == "cuda"
        self._s_host = torch.zeros(self.n_slots, env.state_dim,
                                   pin_memory=pin)
        self._idx_host = torch.zeros(self.n_slots, dtype=torch.int64,
                                     pin_memory=pin)

    # -- cluster registry ----------------------------------------------------
    def register_cluster(self, name: str, env_params=None) -> int:
        """Attach a live cluster (default: the env's declared params).
        Returns its index.  Growing the registry re-stacks the params on the
        next step."""
        if name in self._clusters:
            raise ValueError(f"cluster {name!r} already registered")
        self._clusters[name] = len(self._params_list)
        self._params_list.append(
            self.env.default_params() if env_params is None else env_params)
        self._stacked = None                       # re-stack lazily
        return self._clusters[name]

    @property
    def clusters(self) -> tuple[str, ...]:
        return tuple(self._clusters)

    @property
    def cluster_params(self) -> EnvParams:
        """The registered clusters' params, broadcast-invariant stacked (the
        stack every step gathers from)."""
        if self._stacked is None:
            if not self._params_list:
                raise RuntimeError("no clusters registered — call "
                                   "register_cluster() before serving")
            self._stacked = stack_env_params(self._params_list,
                                             broadcast_invariant=True)
            self._axes = params_in_axes(self._stacked, self._ref)
        return self._stacked

    # -- public API ----------------------------------------------------------
    def submit(self, req: DecisionRequest) -> None:
        if req.cluster not in self._clusters:
            raise KeyError(f"cluster {req.cluster!r} not registered; "
                           f"known: {sorted(self._clusters)}")
        if req.kind is None:
            req.kind = self.kind
        elif req.kind != self.kind:
            raise ValueError(f"request kind {req.kind!r} routed to the "
                             f"{self.kind!r} plane")
        req.submitted_at = time.perf_counter()
        self.queue.append(req)

    def run(self, max_steps: int = 10_000,
            gen: torch.Generator | None = None) -> list[DecisionRequest]:
        """Drain the queue; returns every request finished so far."""
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step(gen)
            steps += 1
        return self._finished

    # -- one engine iteration ------------------------------------------------
    def step(self, gen: torch.Generator | None = None
             ) -> list[DecisionRequest]:
        """Admit from the queue, serve every active slot in one batched
        select, retire + recycle all served slots.  Returns the requests
        decided this step (in slot order: admission order)."""
        self._admit()
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return []
        self.steps += 1
        stacked = self.cluster_params
        s_np, idx_np = self._s_host.numpy(), self._idx_host.numpy()
        s_np[:] = 0.0
        idx_np[:] = 0
        for i, req in active:
            s_np[i] = np.asarray(req.s_vec, np.float32)
            idx_np[i] = self._clusters[req.cluster]
        s_dev = self._s_host.to(self.device, non_blocking=True)
        idx_dev = self._idx_host.to(self.device, non_blocking=True)
        out = batched_select(self.agent, self.state, s_dev, idx_dev, stacked,
                             self._axes, self.explore, gen)
        actions = out.cpu().numpy()                # the step's one pull
        now = time.perf_counter()
        served = []
        for i, req in active:
            req.action = actions[i]
            req.latency_ms = (now - req.submitted_at) * 1e3
            req.done = True
            self.slots[i] = None                   # recycle slot
            self._latencies_ms.append(req.latency_ms)
            self._finished.append(req)
            served.append(req)
        return served

    def _admit(self) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.popleft()

    # -- introspection -------------------------------------------------------
    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue) + self.active

    def decision_stats(self) -> dict:
        """p50/p99/mean decision latency over everything served so far."""
        return latency_stats(self._latencies_ms)

    def reset_stats(self) -> None:
        """Forget finished requests + the latency trace (queue and slots
        must be drained) — lets a bench warm up, then measure a clean
        steady-state window."""
        if self.pending:
            raise RuntimeError("reset_stats with in-flight requests")
        self._finished.clear()
        self._latencies_ms.clear()
        self.steps = 0


class ControlService:
    """One serving endpoint dispatching several decision kinds.

    A thin router over per-kind :class:`ControlPlane`\\ s: requests carry
    ``kind`` and land on the matching plane; one :meth:`step` advances
    every plane (each runs its own batched select — decision kinds have
    different action shapes, so they cannot share a dispatch)."""

    def __init__(self, planes: dict[str, ControlPlane]):
        for kind, plane in planes.items():
            if plane.kind != kind:
                raise ValueError(f"plane for {kind!r} serves {plane.kind!r}")
        self.planes = dict(planes)

    @property
    def kinds(self) -> tuple[str, ...]:
        return tuple(sorted(self.planes))

    def register_cluster(self, name: str, env_params=None) -> None:
        """Register a cluster with EVERY plane (one live cluster asks for
        all decision kinds)."""
        for kind in self.kinds:
            self.planes[kind].register_cluster(name, env_params)

    def submit(self, req: DecisionRequest) -> None:
        if req.kind is None:
            raise ValueError("service requests must carry kind=")
        if req.kind not in self.planes:
            raise KeyError(f"no plane serves kind {req.kind!r}; "
                           f"known: {list(self.kinds)}")
        self.planes[req.kind].submit(req)

    def step(self, gen: torch.Generator | None = None
             ) -> list[DecisionRequest]:
        served: list[DecisionRequest] = []
        for kind in self.kinds:
            served.extend(self.planes[kind].step(gen))
        return served

    def run(self, max_steps: int = 10_000,
            gen: torch.Generator | None = None) -> list[DecisionRequest]:
        steps = 0
        while any(p.pending for p in self.planes.values()) \
                and steps < max_steps:
            self.step(gen)
            steps += 1
        return [r for kind in self.kinds
                for r in self.planes[kind]._finished]

    def decision_stats(self) -> dict[str, dict]:
        return {k: self.planes[k].decision_stats() for k in self.kinds
                if self.planes[k]._latencies_ms}
