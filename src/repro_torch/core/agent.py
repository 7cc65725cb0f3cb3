"""The online-learning control loop over a fleet of lanes.

Port of ``repro/core/agent.py``'s ``History`` and ``run_online_fleet``:
``F`` independent runs step together, every per-lane tensor carrying the
leading ``[F]`` axis, one epoch at a time (the reference's vmapped scan),
each lane under one shared scenario or its own, cut into chunks on a
checkpoint's cadence.  Mesh sharding, the elastic lifecycle and the
non-finite sweep at a chunk's end wait for later slices."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from scipy.signal import butter, filtfilt

from repro_torch.core.api import Agent, EpochDraws, make_epoch_step
from repro_torch.dsdps.simulator import params_lanes


@dataclasses.dataclass
class History:
    """Reward / latency / movement traces of a fleet of runs ([F, T]);
    final_assignment is [F, N, M]."""

    rewards: np.ndarray
    latencies: np.ndarray
    moved: np.ndarray
    final_assignment: np.ndarray

    @property
    def fleet(self) -> int | None:
        """Fleet size, or None for a single-run history."""
        return self.rewards.shape[0] if self.rewards.ndim == 2 else None

    def lane(self, i: int) -> "History":
        """The i-th run of a fleet history as a single-run History."""
        if self.fleet is None:
            raise ValueError("lane() on a single-run History")
        return History(rewards=self.rewards[i], latencies=self.latencies[i],
                       moved=self.moved[i],
                       final_assignment=self.final_assignment[i])

    def normalized_rewards(self) -> np.ndarray:
        """(r - r_min)/(r_max - r_min), the paper's normalization, per lane
        along the epoch axis."""
        r = self.rewards
        lo = r.min(axis=-1, keepdims=True)
        hi = r.max(axis=-1, keepdims=True)
        return (r - lo) / np.maximum(hi - lo, 1e-12)

    def smoothed_rewards(self, cutoff: float = 0.05) -> np.ndarray:
        """Forward-backward (zero-phase) Butterworth low-pass filter, as in
        the paper ([20] Gustafsson filtfilt)."""
        r = self.normalized_rewards()
        if r.shape[-1] < 15:
            return r
        b, a = butter(2, cutoff)
        return filtfilt(b, a, r, axis=-1)

    def seed_band(self, cutoff: float = 0.05) -> tuple[np.ndarray, np.ndarray]:
        """(mean, std) across the fleet axis of the smoothed normalized
        reward curves — the seed-averaged curve and its variance band."""
        r = np.atleast_2d(self.smoothed_rewards(cutoff))
        return r.mean(axis=0), r.std(axis=0)


def chunk_schedule(T: int, every: int | None) -> list[int]:
    """Chunk lengths for ``T`` epochs cut every ``every`` epochs (a trailing
    partial chunk included); ``[T]`` when ``every`` is falsy."""
    if not every:
        return [T]
    chunks = [every] * (T // every)
    if T % every:
        chunks.append(T % every)
    return chunks


def run_online_fleet(
    gen_or_seed: torch.Generator | int,
    env,
    agent: Agent,
    states,
    T: int,
    updates_per_epoch: int = 1,
    explore: bool = True,
    env_params=None,
    draws: Sequence[EpochDraws] | None = None,
    env_state=None,
    checkpoint=None,
    start_epoch: int = 0,
):
    """``T`` online decision epochs for every lane of ``states`` (stacked on
    ``[F]``, e.g. from ``agent.init_fleet``, optionally pretrained).

    Every lane starts from ``env.reset`` unless ``env_state`` (lane-stacked,
    e.g. restored from a checkpoint) is given.  ``env_params`` is one
    scenario for every lane or a lane-stacked fleet of scenarios
    (``dsdps.scenarios.build``), lane ``f`` reset and stepped under its
    own; on a ``StructuralSchedulingEnv`` a lane-stacked
    ``GraphEnvParams`` (``dag_shapes``) gives each lane its own DAG.
    ``draws`` holds one :class:`EpochDraws` per epoch; without it every
    draw comes from the generator (or a generator on ``env.device`` seeded
    with the int).  ``states`` is updated in place.

    ``checkpoint`` (a :class:`repro_torch.checkpoint.FleetCheckpoint`) cuts
    the ``T`` epochs of this call every ``checkpoint.every`` epochs and saves
    the states, the env state and the generator after each chunk, tagged
    ``start_epoch`` plus the epochs done; a run restored from epoch k
    continues as the uninterrupted run would.  ``T`` and ``draws`` count
    the epochs of this call alone.  (The reference also sweeps the carries
    for non-finite values at each chunk's end: not ported yet.)  Returns
    (states, History)."""
    T = int(T)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if draws is not None and len(draws) != T:
        raise ValueError(f"draws holds {len(draws)} epochs, T is {T}")
    if isinstance(gen_or_seed, torch.Generator):
        gen = gen_or_seed
    else:
        gen = torch.Generator(device=env.device).manual_seed(int(gen_or_seed))
    # the non-learning baselines' states are bare tensors ([F] epochs, [F, P]
    # fitted models); the learners' carry a fleet property
    fleet = states.shape[0] if isinstance(states, torch.Tensor) else states.fleet
    params = env.default_params() if env_params is None else env_params
    lanes = params_lanes(params, env.default_params())
    if lanes not in (None, fleet):
        raise ValueError(f"env_params holds {lanes} lanes, the states {fleet}")
    if env_state is None:
        env_state = env.reset(fleet, params)
    step = make_epoch_step(env, agent, env_params=params,
                           updates_per_epoch=updates_per_epoch,
                           explore=explore)
    traces = []
    for n in chunk_schedule(T, None if checkpoint is None else checkpoint.every):
        for t in range(len(traces), len(traces) + n):
            states, env_state, out = step(states, env_state, gen,
                                          None if draws is None else draws[t])
            traces.append(out)
        if checkpoint is not None:
            checkpoint.save(start_epoch + len(traces), states, env_state, gen)
    rewards, lats, moved = (torch.stack(x, dim=-1).cpu().numpy()
                            for x in zip(*traces))
    return states, History(rewards=rewards, latencies=lats, moved=moved,
                           final_assignment=env_state.X.cpu().numpy())
