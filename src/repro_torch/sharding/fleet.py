"""Fleet-axis sharding: cut scenario-fleet carries over a mesh of slots.

Port of ``repro/sharding/fleet.py``.  The fleet runner
(``core/agent.run_online_fleet``) steps every lane of a ``[F]`` fleet
together; everything here is about spreading that axis over the slots of a
``launch.mesh.Mesh``.  A mesh's data axes (every axis except ``"model"``)
carry the fleet: the lane tensors (agent states, env state, the stacked
fields of a scenario fleet) are cut on their leading axis into one block a
slot, each block on its slot's device, while broadcast-invariant params
fields (single-copy in ``stack_env_params(..., broadcast_invariant=True)``)
are replicated on every slot.

Where the reference places global ``jax.Array``s with ``NamedSharding``s,
a process here holds a :class:`FleetBlocks`: the fleet's size and the
blocks of its own slots, each a :class:`Block` (global rows, device,
value).  :func:`fleet_shardings` and :func:`params_partition_specs` are
per-leaf decisions, :data:`SHARD` (cut the leading axis) or
:data:`REPLICATE`; a leaf that cannot be cut (a scalar, a generator, a
leading size the slots do not divide) is replicated, as in the reference.
The reference's ``put_global`` has no counterpart: each process simply
keeps its own rows.

Meshes may span processes (``launch.mesh.make_fleet_mesh(spanning=True)``
after ``init_distributed``): :func:`fleet_host` and
:func:`fleet_host_tree` then bring the blocks home with an ``all_gather``
over the process group, so every process holds the same full tensors."""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import map_tensors, named_leaves
from repro_torch.launch.mesh import Mesh, process_count, process_index

SHARD = "shard"
REPLICATE = "replicate"


class Block(NamedTuple):
    """One slot's share of a fleet carry: the global rows ``[lo, hi)`` it
    holds (all ``F`` when replicated), its device, and the value (a tensor
    or a tree of them) of those rows on that device."""

    rows: tuple[int, int]
    device: torch.device
    value: Any


class FleetBlocks(NamedTuple):
    """A fleet carry of ``fleet`` lanes as this process holds it on a mesh:
    the blocks of its slots, in mesh order; ``replicated`` when every block
    holds all the rows (a fleet the slots do not divide)."""

    fleet: int
    blocks: tuple[Block, ...]
    replicated: bool = False


def is_spanning(mesh: Mesh) -> bool:
    """True when ``mesh`` holds slots of more than one process."""
    me = process_index()
    return any(s.process != me for s in mesh.slots.flat)


def fleet_axes(mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes that carry the fleet: every axis except ``"model"``."""
    return tuple(n for n in mesh.axis_names if n != "model")


def fleet_size(mesh: Mesh) -> int:
    """Number of blocks the fleet axis is cut into."""
    return int(np.prod([mesh.shape[mesh.axis_names.index(a)]
                        for a in fleet_axes(mesh)]))


def compaction_size(n_live: int, mesh: Mesh | None) -> int:
    """Smallest lane count ≥ ``n_live`` a compacted fleet may shrink to.

    A mesh cuts the fleet axis evenly, so on one the elastic lane lifecycle
    (``fleet/lifecycle.py``) compacts to multiples of the data-axis slot
    count, padding with already-stopped "passenger" lanes whose extra
    epochs are discarded.  Without a mesh any size works: ``n_live``."""
    if mesh is None:
        return int(n_live)
    n = fleet_size(mesh)
    return int(-(-int(n_live) // n) * n)          # ceil to a multiple of n


def fleet_shardings(mesh: Mesh, tree) -> dict[str, str]:
    """``{leaf name: SHARD or REPLICATE}`` over ``tree``'s named leaves
    (``checkpoint.named_leaves``): a tensor whose leading size the
    data-axis slot count divides is cut; scalars, generators and leading
    sizes it does not divide are replicated instead of raising, so a
    checkpoint written for fleet 8 restores on 3 slots (lanes replicated):
    the elastic-restore contract."""
    n = fleet_size(mesh)
    return {name: (SHARD if isinstance(x, torch.Tensor) and x.dim() >= 1
                   and x.shape[0] % n == 0 else REPLICATE)
            for name, x in named_leaves(tree)}


def params_partition_specs(params, ref, mesh: Mesh):
    """Per-field :data:`SHARD` / :data:`REPLICATE` of a (possibly
    broadcast-invariant) scenario fleet, in the params' own NamedTuple type:
    a field with one more axis than in the single scenario ``ref`` is
    stacked and cut, the others are replicated.  A single-scenario
    ``params`` replicates everywhere."""
    if len(params) != len(ref):
        raise ValueError("params and reference differ in structure")
    return type(params)(*(SHARD if p.dim() == r.dim() + 1 else REPLICATE
                          for p, r in zip(params, ref)))


def _blocks_rows(mesh: Mesh, fleet: int) -> list[tuple[tuple[int, int], torch.device]]:
    """The rows and device of each of this process's slots for ``fleet``
    lanes (``fleet`` a multiple of the data-axis slot count)."""
    per = fleet // fleet_size(mesh)
    model = mesh.size // fleet_size(mesh)
    return [((pos // model * per, (pos // model + 1) * per), s.device)
            for pos, s in mesh.local_slots()]


def cut(mesh: Mesh, tree, fleet: int) -> FleetBlocks:
    """``tree`` (every tensor stacked on ``[fleet]``) cut into this
    process's blocks, each a copy on its slot's device; replicated on every
    slot when the slots do not divide ``fleet``."""
    if fleet % fleet_size(mesh):
        return FleetBlocks(fleet, tuple(
            Block((0, fleet), s.device, map_tensors(lambda x, d=s.device: x.to(d, copy=True),
                                             tree))
            for _, s in mesh.local_slots()), replicated=True)
    return FleetBlocks(fleet, tuple(
        Block((lo, hi), dev, map_tensors(lambda x, lo=lo, hi=hi, d=dev:
                                  x[lo:hi].to(d, copy=True), tree))
        for (lo, hi), dev in _blocks_rows(mesh, fleet)))


def fleet_of(states) -> int:
    """The lane count of agent states: a :class:`FleetBlocks`' fleet, a bare
    tensor's leading size (the non-learning baselines' ``[F]`` epochs or
    ``[F, P]`` fitted models), or the learners' ``fleet`` property."""
    if isinstance(states, FleetBlocks):
        return states.fleet
    return states.shape[0] if isinstance(states, torch.Tensor) else states.fleet


def _place(mesh: Mesh, tree, fleet: int) -> FleetBlocks:
    """``tree`` as this mesh's blocks: cut, or taken as it is when it already
    is (``checkpoint.FleetCheckpoint.restore(..., mesh=)``'s result)."""
    if not isinstance(tree, FleetBlocks):
        return cut(mesh, tree, fleet)
    want = _blocks_rows(mesh, fleet)
    if tree.fleet != fleet or [(b.rows, b.device) for b in tree.blocks] != want:
        raise ValueError(f"the carry's blocks {[(b.rows, str(b.device)) for b in tree.blocks]} "
                         f"are not this mesh's {[(r, str(d)) for r, d in want]}")
    return tree


def shard_fleet(mesh: Mesh, states, env_state, env_params, ref):
    """Cut the fleet runner's carries over ``mesh``.

    ``states`` and ``env_state`` are cut on their leading fleet axis (or
    taken as they are when already this mesh's :class:`FleetBlocks`);
    ``env_params`` cuts only its stacked fields (``ref``, the env's
    single-scenario ``default_params()``, tells them apart) and replicates
    the broadcast-invariant ones.  The fleet size must be a multiple of the
    data-axis slot count.  Returns ``(states, env_state, env_params,
    params_specs)``, the first three :class:`FleetBlocks` of this process's
    slots in the same order."""
    n = fleet_size(mesh)
    F = fleet_of(states)
    if F % n != 0:
        raise ValueError(
            f"fleet size {F} does not divide over the mesh's {n} data-axis "
            f"slots; pick a fleet that is a multiple of {n} (or run the "
            f"un-meshed runner with mesh=None)")
    specs = params_partition_specs(env_params, ref, mesh)
    states, env_state = _place(mesh, states, F), _place(mesh, env_state, F)
    params = FleetBlocks(F, tuple(
        Block(b.rows, b.device, type(env_params)(*(
            (p[b.rows[0]:b.rows[1]] if s == SHARD else p).to(b.device)
            for p, s in zip(env_params, specs))))
        for b in states.blocks))
    return states, env_state, params, specs


def env_on(env, device: torch.device):
    """``env`` on ``device``: itself when it is there already, else the same
    env (a dataclass) built again on ``device``, for a block whose slot is
    another card."""
    if _same_device(env.device, device):
        return env
    return dataclasses.replace(env, device=device)


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    here = torch.cuda.current_device
    return (a.index if a.index is not None else here()) == \
        (b.index if b.index is not None else here())


def _gather(x: FleetBlocks, device) -> Any:
    """The full value of ``x`` on ``device``, identical on every process."""
    device = torch.device(device)
    if x.replicated:
        return map_tensors(lambda t: t.to(device, copy=True), x.blocks[0].value)
    seen, local = set(), []
    for b in x.blocks:                        # one block a data index
        if b.rows not in seen:
            seen.add(b.rows)
            local.append(b)
    parts = [(b.rows[0], b.value) for b in local]
    if process_count() > 1:
        mine = [(lo, map_tensors(lambda t: t.to("cpu", copy=True), v)) for lo, v in parts]
        every: list = [None] * process_count()
        dist.all_gather_object(every, mine)
        parts = [p for rank in every for p in rank]
    parts.sort(key=lambda p: p[0])
    values = [v for _, v in parts]
    return map_tensors(lambda *ts: torch.cat([t.to(device) for t in ts]), *values)


def fleet_host(x, device="cpu") -> torch.Tensor:
    """Full value of a fleet tensor on every process, on ``device`` (the
    host by default): ``x`` as it is when it is a tensor; the blocks of a
    :class:`FleetBlocks` concatenated in row order, across processes with an
    ``all_gather`` over the process group when the mesh spans them.
    Deterministic and identical on every process, which is what lets every
    process run the same host-side trace accounting and elastic lane
    bookkeeping in lockstep."""
    if isinstance(x, FleetBlocks):
        return _gather(x, device)
    return x.to(device)


def fleet_host_tree(tree, device="cpu"):
    """:func:`fleet_host` of a fleet carry (a :class:`FleetBlocks` of trees);
    any other tree is returned as it is."""
    if isinstance(tree, FleetBlocks):
        return _gather(tree, device)
    return tree
