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

Not ported yet (they wait for ``torch.distributed``): the multi-host
``step_N/proc_P/`` layout with its ``meta.json``, and ``restore(mesh=)``,
which re-places the lanes on another mesh."""
from __future__ import annotations

import pathlib

import torch

from repro_torch.checkpoint.checkpointer import AsyncCheckpointer, Checkpointer


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
        is (elastic-lifecycle runs)."""
        bundle = self._bundle(agent_states, env_state, gen,
                              None if lane_map is None else torch.as_tensor(lane_map))
        if isinstance(self._ck, AsyncCheckpointer):
            self._ck.save_async(epoch, bundle)
        else:
            self._ck.save(epoch, bundle)

    def wait(self) -> None:
        """Block until queued writes are on disk; raises a write's error."""
        if isinstance(self._ck, AsyncCheckpointer):
            self._ck.wait()

    def close(self) -> None:
        if isinstance(self._ck, AsyncCheckpointer):
            self._ck.close()

    # -- restore -------------------------------------------------------------
    def all_epochs(self) -> list[int]:
        return self._ck.all_steps()

    def latest_epoch(self) -> int | None:
        """Newest restorable epoch, or None when the directory is empty."""
        return self._ck.latest_step()

    def _lanes_entry(self, epoch: int) -> dict | None:
        return next((e for e in self._ck.manifest(epoch)["leaves"]
                     if e["name"] == "lanes"), None)

    def has_lane_map(self, epoch: int | None = None) -> bool:
        """True when the snapshot at ``epoch`` (default: the latest) was
        written with a lane map, by an elastic-lifecycle run."""
        self.wait()
        epoch = self.latest_epoch() if epoch is None else epoch
        return epoch is not None and self._lanes_entry(epoch) is not None

    def restore(self, agent_states, env_state, gen: torch.Generator,
                epoch: int | None = None, with_lane_map: bool = False):
        """Load the carries saved at ``epoch`` (default: the latest) into
        ``agent_states``, ``env_state`` and ``gen``, in place (pass freshly
        made ones of the run's shapes, on any device; ``gen`` of the
        device type the run drew on).  Returns ``(epoch, agent_states,
        env_state, gen)``, and with ``with_lane_map=True`` also the
        ``[fleet]`` original-lane array of an elastic run's snapshot."""
        self.wait()
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no fleet checkpoints in {self.directory}")
        lanes = None
        if with_lane_map:
            ent = self._lanes_entry(epoch)
            lanes = (torch.zeros(ent["shape"], dtype=getattr(torch, ent["dtype"]))
                     if ent is not None else torch.zeros(0, dtype=torch.int64))
        self._ck.restore(self._bundle(agent_states, env_state, gen, lanes),
                         step=epoch)
        if with_lane_map:
            return epoch, agent_states, env_state, gen, lanes.numpy()
        return epoch, agent_states, env_state, gen
