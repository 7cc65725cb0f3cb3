"""Meshes of fleet slots, and multi-process initialization.

Port of ``repro/launch/mesh.py``.  Everything here is a function: importing
this module touches neither a device nor the process group.

The reference's meshes are ``jax.sharding.Mesh`` objects over devices; the
port's :class:`Mesh` is a small frozen class of its own, since a fleet
mesh may place several slots on one device (the reference emulates
several CPU devices a process with ``--xla_force_host_platform_device_count``;
``torch.distributed``'s ``DeviceMesh`` wants one device a rank).  A mesh
has a ``shape``, its ``axis_names`` (``("data", "model")``, or ``("pod",
"data", "model")`` from ``fault.elastic.plan_mesh``) and a ``slots``
array of that shape, each slot a :class:`Slot` ``(process, device)``: one
block of a fleet's lanes runs on each slot (``sharding/fleet.py``).

A process's local slots are, in order of precedence: ``REPRO_FLEET_SLOTS``
slots on the process's device (the count the multi-host supervisor exports,
the counterpart of the XLA flag: on the CPU this is how one process gets 2
or 4 slots; on one GPU it places several on ``cuda:0``); on CUDA without a
card index, one slot per visible card; else one slot on the device.  A
slot that names CUDA raises without a GPU, as ``device.resolve_device``
does.

:func:`init_distributed` joins a multi-process job: call it first thing in
every worker process, before any CUDA call, then build spanning meshes.
Single-process calls are a no-op, so the same launcher runs unmodified on
one host.

:func:`make_production_mesh` is the LM training mesh: a ``torch.distributed``
``DeviceMesh`` over the process group's world, one device a rank, shaped
``(data, model)`` or ``(pod, data, model)`` by ``fault.elastic.plan_mesh``.
Its gradients cross devices, so on the card it runs on NCCL; the fleet's
meshes stay on gloo (``init_distributed``'s default), since NCCL refuses
two ranks on one card, which is how the multi-host drill runs on one GPU."""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# environment variables the localhost supervisor (repro_torch.launch.multihost)
# sets for its workers; a real cluster can export the same three
COORDINATOR_ENV = "REPRO_COORDINATOR"
NUM_PROCESSES_ENV = "REPRO_NUM_PROCESSES"
PROCESS_ID_ENV = "REPRO_PROCESS_ID"
# the slots a process places on its device (the supervisor's --devices-per-proc)
SLOTS_ENV = "REPRO_FLEET_SLOTS"


class Slot(NamedTuple):
    """Where one block of a fleet runs: a process and a device of it."""

    process: int
    device: torch.device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of fleet slots: ``slots`` is an object array of ``shape``
    holding one :class:`Slot` per position, named by ``axis_names``."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    slots: np.ndarray

    @property
    def size(self) -> int:
        return int(self.slots.size)

    def local_slots(self) -> list[tuple[int, Slot]]:
        """``(position in the flat slot order, slot)`` of every slot of this
        process, in mesh order."""
        me = process_index()
        return [(i, s) for i, s in enumerate(self.slots.flat) if s.process == me]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"slots={[(s.process, str(s.device)) for s in self.slots.flat]})")


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str = "gloo") -> tuple[int, int]:
    """Join (or skip) a multi-process job; returns ``(process_id, n)``.

    The arguments default to ``REPRO_COORDINATOR`` (``host:port``),
    ``REPRO_NUM_PROCESSES`` and ``REPRO_PROCESS_ID``, which
    ``repro_torch.launch.multihost`` exports for its localhost workers.  With
    no coordinator, or ``num_processes <= 1``, this is a no-op returning
    ``(0, 1)``.  Idempotent: a second call returns the current rank and
    world size.

    The process group is ``torch.distributed`` on ``backend``: ``"gloo"``
    (the default) for a fleet, on the CPU and on the card alike.  A fleet's
    lanes are independent, so nothing crosses processes on the hot path:
    the only cross-process traffic is on the host (traces and states
    brought home by ``sharding.fleet.fleet_host``, an ``all_gather`` of
    host tensors; the checkpoint barrier; the generator state, written
    once), and NCCL would refuse two ranks on one card, which is how the
    multi-host drill runs on a single GPU.  LM training passes ``"nccl"``
    on the card (its gradients cross devices) and ``"gloo"`` on the CPU
    (:func:`lm_backend`).  Call this before any CUDA call; a failed NCCL
    initialization raises."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get(COORDINATOR_ENV)
    if num_processes is None and env.get(NUM_PROCESSES_ENV):
        num_processes = int(env[NUM_PROCESSES_ENV])
    if process_id is None and env.get(PROCESS_ID_ENV):
        process_id = int(env[PROCESS_ID_ENV])
    if coordinator_address is None or (num_processes or 1) <= 1:
        return 0, 1
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(minutes=10))
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    """This process's rank, 0 outside a multi-process job."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The job's process count, 1 outside a multi-process job."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def local_slots(device: str | torch.device | None = None) -> list[Slot]:
    """This process's slots (the module docstring's order of precedence)
    on ``device`` (default CUDA; raises without a GPU)."""
    dev = resolve_device(device)
    me = process_index()
    count = os.environ.get(SLOTS_ENV)
    if count:
        return [Slot(me, dev)] * int(count)
    if dev.type == "cuda" and dev.index is None:
        return [Slot(me, torch.device("cuda", i))
                for i in range(torch.cuda.device_count())]
    return [Slot(me, dev)]


def slot_grid(slots: list[Slot], shape: tuple[int, ...]) -> np.ndarray:
    """``slots`` as an object array of ``shape`` (one slot an element)."""
    grid = np.empty(len(slots), dtype=object)
    for i, s in enumerate(slots):       # a Slot is a tuple: set one by one
        grid[i] = s
    return grid.reshape(shape)


def make_host_mesh(device: str | torch.device | None = None) -> Mesh:
    """The degenerate 1×1 mesh: one slot on ``device`` (default CUDA).  A
    ``run_online_fleet(..., mesh=make_host_mesh("cpu"))`` run cuts nothing,
    so its lanes are the bit-comparability anchor of the meshed path."""
    return Mesh((1, 1), ("data", "model"),
                slot_grid([Slot(process_index(), resolve_device(device))], (1, 1)))


def make_fleet_mesh(n_devices: int | None = None, spanning: bool = False,
                    device: str | torch.device | None = None) -> Mesh:
    """The data-only ``(n, 1)`` mesh over ``("data", "model")`` the fleet
    runner cuts its lanes over.

    ``spanning=False`` uses this process's slots (:func:`local_slots` on
    ``device``); ``spanning=True`` every slot of every process of the job,
    process by process (each process's own gathered over the process group;
    in a single-process job the local mesh).  ``n_devices`` takes the first
    ``n`` of them and raises ``ValueError`` when there are fewer."""
    slots = local_slots(device)
    if spanning and process_count() > 1:
        every: list = [None] * process_count()
        dist.all_gather_object(every, [(s.process, str(s.device)) for s in slots])
        slots = [Slot(p, torch.device(d)) for mine in every for p, d in mine]
    n = len(slots) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(slots):
        raise ValueError(f"a mesh of {n} slots does not fit the {len(slots)} "
                         f"slots available (set {SLOTS_ENV} for more a device)")
    return Mesh((n, 1), ("data", "model"), slot_grid(slots[:n], (n, 1)))


def lm_backend(device: str | torch.device | None = None) -> str:
    """The process group backend of LM training on ``device`` (default
    CUDA; raises without a GPU): NCCL on the card, gloo on the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def make_production_mesh(multi_pod: bool = False,
                         device: str | torch.device | None = None):
    """The LM training mesh: a ``DeviceMesh`` over every rank of the process
    group on ``device`` (default CUDA; raises without a GPU), shaped by
    ``fault.elastic.plan_mesh(world, model_parallel=16, multi_pod=)``: the
    documented 16×16 (or 2×16×16 with ``multi_pod``) on a full pod, and
    on anything smaller the largest (data, model) grid that fits, so one
    process gets a 1×1 mesh.

    With no process group this starts a world of one itself, on an
    in-process store, so it works without any environment variable (NCCL
    on the card, gloo on the CPU).  On CUDA each rank takes the card of its
    rank modulo the visible cards."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.fault.elastic import plan_mesh

    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        dist.init_process_group(lm_backend(dev), store=dist.HashStore(), rank=0,
                                world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    plan = plan_mesh(dist.get_world_size(), model_parallel=16, multi_pod=multi_pod)
    return init_device_mesh(dev.type, tuple(plan.shape), mesh_dim_names=tuple(plan.axes))
