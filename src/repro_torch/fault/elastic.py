"""Elastic re-meshing: when workers die, plan the best surviving mesh and
resume from the newest checkpoint.

Port of ``repro/fault/elastic.py``.  Two restore families share the
mesh-planning policy:

* **LM training**: keep the model axis whole if possible (a tensor-parallel
  group spans a pod's fast links; losing a chip in it takes the whole group
  out) and shrink the data axis to what the survivors fit.  Plan with
  :func:`plan_mesh`; the LM sharding that restores onto the plan comes
  with a later slice.
* **Fleet control runs** (``core/agent.run_online_fleet``):
  :func:`resume_after_failure` plans a data-only mesh over the surviving
  slots and restores the fleet's carries (agent states, env state, the
  generator) through ``FleetCheckpoint.restore(..., mesh=)``, cut over the
  new mesh (replicated when the fleet no longer divides it).  Elastic-
  lifecycle runs checkpoint a compacted fleet with a lane map; pass
  ``with_lane_map=True`` to get it back.  ``launch/multihost.py`` sizes the
  relaunch after a worker dies with ``plan_mesh(model_parallel=1)``."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.launch.mesh import Mesh, local_slots, slot_grid


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def device_count(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(alive_devices: int, model_parallel: int = 16,
              multi_pod: bool = False) -> MeshPlan:
    """Largest (data, model) grid that fits the survivors.

    ``model_parallel=1`` plans the data-only ``(n, 1)`` grid fleet control
    runs use (``launch.mesh.make_fleet_mesh``); the multi-host supervisor
    (``repro_torch.launch.multihost``) calls it that way to size the
    reduced mesh after a worker process dies."""
    alive_devices = int(alive_devices)
    if alive_devices < 1:
        raise ValueError(
            f"cannot plan a mesh over {alive_devices} alive device(s)")
    if alive_devices < model_parallel:
        # degrade tensor parallelism too (rare: a whole pod's worth of failures)
        mp = 1
        while mp * 2 <= alive_devices:
            mp *= 2
        model_parallel = mp
    data = alive_devices // model_parallel
    if multi_pod and data % 2 == 0 and data >= 2:
        return MeshPlan((2, data // 2, model_parallel),
                        ("pod", "data", "model"))
    return MeshPlan((data, model_parallel), ("data", "model"))


def make_mesh(plan: MeshPlan, device=None) -> Mesh:
    """The port's :class:`~repro_torch.launch.mesh.Mesh` of ``plan``'s shape
    and axes over the first ``plan.device_count`` of this process's slots
    on ``device`` (default CUDA); ``ValueError`` when there are fewer."""
    slots = local_slots(device)
    n = plan.device_count
    if n > len(slots):
        raise ValueError(f"plan {plan.shape} needs {n} slots; this process has "
                         f"{len(slots)}")
    return Mesh(tuple(plan.shape), tuple(plan.axes),
                slot_grid(slots[:n], tuple(plan.shape)))


def resume_after_failure(checkpoint, env, agent, gen, states, env_state=None,
                         env_params=None, alive_devices: int | None = None,
                         with_lane_map: bool = False):
    """The whole elastic-restart path of a fleet control run: plan a
    data-only mesh over the survivors, restore the fleet's carries cut over
    it, and hand back what ``run_online_fleet`` needs to go on.

    ``checkpoint`` is a ``FleetCheckpoint`` over the dead run's directory;
    ``agent`` the ``make_agent(...)`` bundle the run trained; ``gen``,
    ``states`` and ``env_state`` templates of the carries (freshly made;
    the generator of the device type the run drew on); ``env_params`` the
    run's scenario fleet, which builds the env-state template when
    ``env_state`` is None; ``alive_devices`` the surviving slot count
    (default: every slot of this process, ``launch.mesh.local_slots`` on
    ``env.device``).  With ``with_lane_map=True`` an elastic-lifecycle
    snapshot (a compacted fleet) is read: the templates are cut to its
    width and the original-lane array is appended to the return.

    Returns ``(mesh, epoch, states, env_state, gen[, lane_map])``, the
    carries this process's ``FleetBlocks``: feed them to
    ``run_online_fleet(..., mesh=mesh, start_epoch=epoch, T=remaining)``
    (the launcher's ``--resume`` is this function as a CLI)."""
    from repro_torch.core.api import Agent
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.sharding.fleet import fleet_of
    if not isinstance(agent, Agent):
        raise TypeError(
            f"expected an api.Agent (make_agent(...)), got "
            f"{type(agent).__name__}")
    mesh = make_fleet_mesh(alive_devices, device=env.device)
    F = fleet_of(states)
    if env_state is None:
        env_state = env.reset(F, env_params)
    if with_lane_map:
        from repro_torch.fleet.lifecycle import take_lanes
        checkpoint.wait()
        ent = checkpoint._lanes_entry(checkpoint.latest_epoch())
        if ent is not None:
            width = np.arange(ent["shape"][0])
            states, env_state = take_lanes(states, width), take_lanes(env_state, width)
    out = checkpoint.restore(states, env_state, gen, mesh=mesh,
                             with_lane_map=with_lane_map)
    return (mesh, *out)
