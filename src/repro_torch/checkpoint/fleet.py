"""Fleet-training checkpoints: periodic, asynchronous, atomic.

Port of the single-process half of ``repro/checkpoint/fleet.py``.
:class:`FleetCheckpoint` wraps the generic
:class:`~repro_torch.checkpoint.checkpointer.Checkpointer` around the fleet
runner's carries, tagged by absolute decision epoch:
``core.agent.run_online_fleet(..., checkpoint=ck)`` cuts its epochs every
``ck.every`` and calls :meth:`FleetCheckpoint.save` after each chunk.  By
default the save is asynchronous and overlapped: the caller only clones the
carries on the card and starts their copies to pinned host memory; the
background writer finishes the transfer and writes, double-buffered at two
snapshots in flight.  A step directory is renamed into place only once
every leaf and the manifest are on disk, so a kill mid-write never spoils
the newest restorable state.

The bundle is ``{"agent", "env", "gen"[, "lanes"]}``: the lanes' agent
states, their env state, and the one ``torch.Generator`` the whole fleet
draws from, where the reference carries a ``[F]`` array of PRNG keys.
Elastic-lifecycle runs compact their fleet as lanes converge;
``save(..., lane_map=...)`` records which original lanes the surviving rows
are and ``restore(..., with_lane_map=True)`` returns that map.

A meshed run (``run_online_fleet(..., mesh=)``) hands the save this
process's blocks (``sharding.FleetBlocks``).  In a single-process job they
are concatenated on the card and saved as above.  In a multi-process job
(``launch.mesh.init_distributed``, more than one rank) the save switches
to the per-process layout, synchronously (the async writer stays
single-process, as in the reference):

  <dir>/step_%08d/
      proc_%05d/      process P's manifest and leaf files: one file a block
                      of each cut leaf, tagged with the global rows it
                      holds; the replicated leaves (the generator's state,
                      the lane map, any whole tree) written once, by
                      process 0
      meta.json       {"epoch", "process_count", "layout", "save_s"},
                      written by process 0 after a barrier of the process
                      group (``save_s``: its wall s of the save)

Each process stages ``proc_P`` as ``.tmp_step_%08d_proc%05d`` and renames
it into place; a step counts (:meth:`FleetCheckpoint.latest_epoch`) only
once its ``meta.json`` exists, so a process dying mid-save never publishes
a half step.  :meth:`FleetCheckpoint.restore` reads either layout, the
multi-host one by concatenating whatever ``proc_*`` directories exist in
row order (2 processes' save restores on 1, and the reverse), and given a
mesh returns each of this process's slots' block
(``sharding.fleet.cut``; replicated when the fleet no longer divides the
mesh, as ``sharding.fleet_shardings`` decides)."""
from __future__ import annotations

import json
import pathlib
import shutil
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer, Checkpointer,
                                                 dtype_name, host_copy,
                                                 named_leaves, read_leaf,
                                                 write_leaf)
from repro_torch.launch.mesh import process_count, process_index
from repro_torch.sharding.fleet import FleetBlocks, cut, fleet_host_tree


class FleetCheckpoint:
    """Checkpoint policy and storage for ``run_online_fleet``'s carries.

    ``every`` is the cadence in decision epochs (the runner cuts its epochs
    on this boundary); ``keep`` the number of checkpoints kept (older step
    directories are removed); ``use_async=False`` writes on the caller's
    thread; ``overlap_transfer=False`` (asynchronous writes only) takes the
    device-to-host copies on the caller's thread too."""

    def __init__(self, directory: str | pathlib.Path, every: int = 50,
                 keep: int = 3, use_async: bool = True,
                 overlap_transfer: bool = True):
        if every < 1:
            raise ValueError(f"checkpoint cadence must be >= 1, got {every}")
        self.every = int(every)
        self._ck = (AsyncCheckpointer(directory, keep=keep,
                                      overlap_transfer=overlap_transfer)
                    if use_async else Checkpointer(directory, keep=keep))
        # wall s of each save on the caller's thread (a multi-host save's
        # barrier and publication included)
        self.save_seconds: list[float] = []

    @property
    def directory(self) -> pathlib.Path:
        return self._ck.dir

    @staticmethod
    def _bundle(agent_states, env_state, gen, lane_map=None) -> dict:
        bundle = {"agent": agent_states, "env": env_state, "gen": gen}
        if lane_map is not None:
            bundle["lanes"] = lane_map
        return bundle

    # -- save ----------------------------------------------------------------
    def save(self, epoch: int, agent_states, env_state, gen: torch.Generator,
             lane_map=None) -> None:
        """Snapshot the carries at absolute ``epoch``: asynchronously when
        constructed with ``use_async=True`` (the caller's next epoch may
        write the live tensors in place at once).  ``lane_map`` is an
        optional ``[fleet]`` integer array naming the original lane each row
        is (elastic-lifecycle runs).

        ``agent_states`` and ``env_state`` may be a meshed run's
        ``FleetBlocks``.  In a multi-process job every process calls this
        with the same ``epoch`` (the chunk schedule is deterministic, so
        they do) and the save takes the per-process layout (the module
        docstring)."""
        t0 = time.perf_counter()
        lanes = None if lane_map is None else torch.as_tensor(lane_map)
        if process_count() > 1:
            self._save_multihost(epoch, self._bundle(agent_states, env_state,
                                                     gen, lanes), t0)
        else:
            # one process holds every block: whole on the blocks' device
            whole = [fleet_host_tree(x, x.blocks[0].device)
                     if isinstance(x, FleetBlocks) else x
                     for x in (agent_states, env_state)]
            bundle = self._bundle(*whole, gen, lanes)
            if isinstance(self._ck, AsyncCheckpointer):
                self._ck.save_async(epoch, bundle)
            else:
                self._ck.save(epoch, bundle)
        self.save_seconds.append(time.perf_counter() - t0)

    def _save_multihost(self, epoch: int, bundle: dict, t0: float) -> None:
        """The per-process save (synchronous, collective): this process's
        rows of every cut carry into ``step_N/proc_P/``, the replicated
        leaves by process 0, then a barrier and process 0's ``meta.json``."""
        self.wait()
        pid, nprocs = process_index(), process_count()
        root = self._ck.dir
        step_dir = root / f"step_{epoch:08d}"
        step_dir.mkdir(parents=True, exist_ok=True)
        tmp = root / f".tmp_step_{epoch:08d}_proc{pid:05d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        entries = []

        def write(name: str, t: torch.Tensor, rows=None, global_shape=None):
            ent = write_leaf(tmp, len(entries), name, t)
            if rows is not None:
                ent["rows"], ent["global_shape"] = list(rows), list(global_shape)
            entries.append(ent)

        for key in sorted(bundle):
            part = bundle[key]
            if isinstance(part, FleetBlocks) and not part.replicated:
                seen = set()
                for b in part.blocks:         # one file a block of each leaf
                    if b.rows in seen:
                        continue
                    seen.add(b.rows)
                    for name, leaf in named_leaves(b.value):
                        host = host_copy(leaf)
                        write(f"{key}.{name}" if name else key, host, b.rows,
                              (part.fleet, *host.shape[1:]))
            elif pid == 0:                    # replicated: one copy, process 0
                if isinstance(part, FleetBlocks):
                    part = part.blocks[0].value
                for name, leaf in named_leaves(part):
                    write(f"{key}.{name}" if name else key, host_copy(leaf))
        (tmp / "manifest.json").write_text(json.dumps(
            {"epoch": int(epoch), "process": pid, "leaves": entries}))
        proc_dir = step_dir / f"proc_{pid:05d}"
        if proc_dir.exists():
            shutil.rmtree(proc_dir)
        tmp.rename(proc_dir)                  # atomic per process
        dist.barrier()
        if pid == 0:
            # save_s: process 0's wall s of this save, the barrier included
            (step_dir / "meta.json").write_text(json.dumps(
                {"epoch": int(epoch), "process_count": nprocs,
                 "layout": "multihost-v1", "save_s": time.perf_counter() - t0}))
            steps = self.all_epochs()
            for old in steps[: max(len(steps) - self._ck.keep, 0)]:
                shutil.rmtree(root / f"step_{old:08d}", ignore_errors=True)

    def wait(self) -> None:
        """Block until queued writes are on disk; raises a write's error."""
        if isinstance(self._ck, AsyncCheckpointer):
            self._ck.wait()

    def close(self) -> None:
        if isinstance(self._ck, AsyncCheckpointer):
            self._ck.close()

    # -- restore -------------------------------------------------------------
    def all_epochs(self) -> list[int]:
        """Restorable epochs: single-process steps (``manifest.json``) and
        COMPLETE multi-host steps (``meta.json``, written by process 0 only
        after every process's directory is on disk)."""
        return sorted(int(p.name.split("_")[1]) for p in self._ck.dir.glob("step_*")
                      if (p / "manifest.json").exists() or (p / "meta.json").exists())

    def latest_epoch(self) -> int | None:
        """Newest restorable epoch, or None when the directory is empty."""
        steps = self.all_epochs()
        return steps[-1] if steps else None

    def _manifests(self, epoch: int) -> list[tuple[pathlib.Path, dict]]:
        """``(directory, manifest)`` of every part of the step: one for the
        single-process layout, one a ``proc_*`` directory for the multi-host
        one."""
        d = self._ck.dir / f"step_{epoch:08d}"
        if (d / "manifest.json").exists():
            return [(d, json.loads((d / "manifest.json").read_text()))]
        return [(p, json.loads((p / "manifest.json").read_text()))
                for p in sorted(d.glob("proc_*"))]

    def _lanes_entry(self, epoch: int) -> dict | None:
        return next((e for _, m in self._manifests(epoch) for e in m["leaves"]
                     if e["name"] == "lanes"), None)

    def is_multihost(self, epoch: int | None = None) -> bool:
        """True when the snapshot at ``epoch`` (default: the latest) was
        written in the per-process layout (``meta.json`` and ``proc_*``)."""
        self.wait()
        epoch = self.latest_epoch() if epoch is None else epoch
        return (epoch is not None and
                (self._ck.dir / f"step_{epoch:08d}" / "meta.json").exists())

    def has_lane_map(self, epoch: int | None = None) -> bool:
        """True when the snapshot at ``epoch`` (default: the latest) was
        written with a lane map, by an elastic-lifecycle run."""
        self.wait()
        epoch = self.latest_epoch() if epoch is None else epoch
        return epoch is not None and self._lanes_entry(epoch) is not None

    def restore(self, agent_states, env_state, gen: torch.Generator,
                epoch: int | None = None, with_lane_map: bool = False,
                mesh=None):
        """Load the carries saved at ``epoch`` (default: the latest) into
        ``agent_states``, ``env_state`` and ``gen``, in place (pass freshly
        made ones of the run's shapes, on any device; ``gen`` of the
        device type the run drew on), from either layout.  Returns
        ``(epoch, agent_states, env_state, gen)``, and with
        ``with_lane_map=True`` also the ``[fleet]`` original-lane array of an
        elastic run's snapshot.

        With a ``mesh`` (a ``launch.mesh.Mesh``) the agent states and the
        env state come back as this process's ``FleetBlocks``: each local
        slot's rows on its device, or every row on every slot when the
        fleet no longer divides the mesh (a replicated carry, which the
        meshed runner refuses as it refuses such a fleet)."""
        self.wait()
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no fleet checkpoints in {self.directory}")
        lanes = None
        if with_lane_map:
            ent = self._lanes_entry(epoch)
            lanes = (torch.zeros(ent["shape"], dtype=getattr(torch, ent["dtype"]))
                     if ent is not None else torch.zeros(0, dtype=torch.int64))
        like = self._bundle(agent_states, env_state, gen, lanes)
        if self.is_multihost(epoch):
            self._restore_multihost(like, epoch)
        else:
            self._ck.restore(like, step=epoch)
        if mesh is not None:
            F = env_state.X.shape[0]
            agent_states, env_state = (cut(mesh, x, F) for x in (agent_states,
                                                                 env_state))
        if with_lane_map:
            return epoch, agent_states, env_state, gen, lanes.numpy()
        return epoch, agent_states, env_state, gen

    def _restore_multihost(self, like: dict, epoch: int) -> None:
        """A per-process save's leaves assembled whole, in row order, into
        ``like``'s tensors and generator, in place."""
        full: dict[str, torch.Tensor] = {}
        covered: dict[str, int] = {}
        for d, manifest in self._manifests(epoch):
            for ent in manifest["leaves"]:
                arr = read_leaf(d, ent)
                name = ent["name"]
                if ent.get("rows") is None:
                    full[name], covered[name] = arr, -1
                    continue
                if name not in full:
                    full[name] = torch.zeros(ent["global_shape"], dtype=arr.dtype)
                    covered[name] = 0
                lo, hi = ent["rows"]
                full[name][lo:hi] = arr
                covered[name] += hi - lo
        step = self._ck.dir / f"step_{epoch:08d}"
        for name, got in covered.items():
            if 0 <= got < full[name].shape[0]:
                raise IOError(f"multi-host checkpoint step {epoch} is missing fleet "
                              f"rows of {name}: {got}/{full[name].shape[0]} covered "
                              f"(an incomplete set of process directories in {step})")
        named = named_leaves(like)
        missing = [n for n, _ in named if n not in full]
        if missing:
            raise IOError(f"multi-host checkpoint step {epoch} lacks leaves "
                          f"{missing} (template and layout differ)")
        with torch.no_grad():
            for name, leaf in named:
                value = full[name]
                if isinstance(leaf, torch.Generator):
                    leaf.set_state(value)
                    continue
                if list(leaf.shape) != list(value.shape) or leaf.dtype != value.dtype:
                    raise ValueError(f"checkpoint leaf {name} is "
                                     f"{dtype_name(value)}{list(value.shape)}, the "
                                     f"template's {dtype_name(leaf)}{list(leaf.shape)}")
                leaf.copy_(value)
