"""The online-learning control loop over a fleet of lanes.

Port of ``repro/core/agent.py``'s ``History``, ``run_online_fleet`` and
``run_online_agent`` (one run: a fleet of one, through the same loop):
``F`` independent runs step together, every per-lane tensor carrying the
leading ``[F]`` axis, one epoch at a time (the reference's vmapped scan),
each lane under one shared scenario or its own, cut into chunks on a
checkpoint's cadence, the carries swept for non-finite values after each
chunk inside a ``diagnostics.guards`` region; ``lifecycle=`` hands the run
to the elastic lane lifecycle (``fleet/lifecycle.py``); ``mesh=`` cuts the
lanes over the slots of a ``launch.mesh.Mesh`` (``sharding/fleet.py``),
across processes when it spans them; and the deploy-time action of a
trained DDPG fleet, ``greedy_assignment_ddpg``.

The reference runs a meshed fleet as one ``shard_map`` program; the port
runs the block of each of this process's slots through
``make_epoch_step`` for each chunk, one block after another on the same
stream.  Its draws cannot come from the one generator the unmeshed fleet
draws from in its own order (a process runs only its blocks), so a meshed
run draws each epoch's :class:`EpochDraws` fleet-wide (``api.draw_epoch``)
from a generator every process seeds alike and each block takes its rows:
lane f of a meshed run does not depend on the mesh, the slot count or the
process count, and on the same explicit ``draws`` it equals lane f of the
unmeshed run."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from scipy.signal import butter, filtfilt

from repro_torch.core.api import (Agent, EpochDraws, draw_epoch,
                                  make_epoch_step, params_are_stacked)
from repro_torch.core.ddpg import DDPGConfig, DDPGState, select_action
from repro_torch.diagnostics import lifted, maybe_check_finite, steady
from repro_torch.dsdps.simulator import params_lanes
from repro_torch.sharding.fleet import (Block, FleetBlocks, env_on, fleet_host,
                                        fleet_host_tree, fleet_of, shard_fleet)


@dataclasses.dataclass
class History:
    """Reward / latency / movement traces of one run ([T]) or of a fleet of
    runs ([F, T]); final_assignment is [N, M] or [F, N, M]."""

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


def _require_agent(agent) -> Agent:
    """The runners take ``api.Agent`` bundles only."""
    if not isinstance(agent, Agent):
        raise TypeError(
            f"expected an api.Agent, got {type(agent).__name__}; build one "
            f"with make_agent(name, env, cfg=...) or ddpg/dqn.as_agent(cfg)")
    return agent


def prepare_fleet(gen_or_seed: torch.Generator | int, env, states,
                  env_params=None, env_state=None):
    """The fleet runners' common set-up: the generator (or one on
    ``env.device`` seeded with the int), the lane count of ``states``, the
    scenario (``env.default_params()`` when None; a lane-stacked one must
    hold as many lanes as the states) and the env state (every lane from
    ``env.reset`` when None).  Returns ``(gen, fleet, params, env_state)``;
    a meshed runner then cuts them with ``sharding.fleet.shard_fleet``."""
    if isinstance(gen_or_seed, torch.Generator):
        gen = gen_or_seed
    else:
        gen = torch.Generator(device=env.device).manual_seed(int(gen_or_seed))
    fleet = fleet_of(states)
    params = env.default_params() if env_params is None else env_params
    lanes = params_lanes(params, env.default_params())
    if lanes not in (None, fleet):
        raise ValueError(f"env_params holds {lanes} lanes, the states {fleet}")
    if env_state is None:
        env_state = env.reset(fleet, params)
    return gen, fleet, params, env_state


def run_chunk(step, states, env_state, gen: torch.Generator, n: int,
              draws: Sequence[EpochDraws] | None = None):
    """``n`` epochs of ``step`` (``make_epoch_step``'s), the steady state:
    inside a ``diagnostics.guards`` region its sync guard is armed over
    these epochs alone (``diagnostics.steady``).  ``draws`` holds the
    chunk's ``n`` epochs or is None.  Returns ``(states, env_state,
    rewards, latencies, moved)``, the traces ``[F, n]`` tensors on the
    device."""
    with steady(n):
        return _epochs(step, states, env_state, gen, n, draws)


def _epochs(step, states, env_state, gen, n: int, draws):
    outs = []
    for t in range(n):
        states, env_state, out = step(states, env_state, gen,
                                      None if draws is None else draws[t])
        outs.append(out)
    return (states, env_state, *(torch.stack(x, dim=-1) for x in zip(*outs)))


def block_steps(env, agent: Agent, params: FleetBlocks,
                updates_per_epoch: int = 1, explore: bool = True) -> list:
    """One ``make_epoch_step`` a block of ``params``, each on its slot's
    device and under the block's rows of the scenario."""
    return [make_epoch_step(env_on(env, b.device), agent, env_params=b.value,
                            updates_per_epoch=updates_per_epoch, explore=explore)
            for b in params.blocks]


def run_blocks(steps: list, states: FleetBlocks, env_state: FleetBlocks,
               gen: torch.Generator, n: int, env, agent: Agent,
               draws: Sequence[EpochDraws] | None = None,
               updates_per_epoch: int = 1, rows=None, width: int | None = None):
    """``n`` epochs of every block of this process (``block_steps``'), one
    block after another on the same stream, the meshed runners' chunk.

    Each epoch's draws are fleet-wide: ``draws`` (``n`` epochs at the width
    the draws were made for) or, when None, ``api.draw_epoch`` from ``gen``
    at ``width`` (default: the carries'), all ``n`` epochs before any block
    runs.  A block of rows ``[lo, hi)`` takes the draws' rows
    ``rows[lo:hi]`` (``rows``: an elastic fleet's original row of each
    compact position; the identity when None).  Returns ``(states,
    env_state, traces)``, ``traces`` a :class:`FleetBlocks` of ``(rewards,
    latencies, moved)`` ``[rows, n]``."""
    F = states.fleet
    if draws is None:
        draws = [draw_epoch(gen, env, agent, width or F, updates_per_epoch)
                 for _ in range(n)]
    new_s, new_e, traces = [], [], []
    with steady(n):
        for step, sb, eb in zip(steps, states.blocks, env_state.blocks):
            (lo, hi), dev = sb.rows, sb.device
            at = torch.as_tensor(np.arange(lo, hi) if rows is None
                                 else np.asarray(rows)[lo:hi])
            mine = [EpochDraws(*(x.index_select(0, at.to(x.device)).to(dev)
                                 for x in d)) for d in draws]
            s, e, *out = _epochs(step, sb.value, eb.value, None, n, mine)
            new_s.append(Block(sb.rows, dev, s))
            new_e.append(Block(eb.rows, dev, e))
            traces.append(Block(sb.rows, dev, tuple(out)))
    return (FleetBlocks(F, tuple(new_s)), FleetBlocks(F, tuple(new_e)),
            FleetBlocks(F, tuple(traces)))


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
    lifecycle=None,
    mesh=None,
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
    the epochs of this call alone.  After each chunk, before the save, the
    states and the chunk's rewards are swept for non-finite values
    (``diagnostics.maybe_check_finite``: a ``NonFiniteError`` inside a
    ``guards(nan_check=True)`` region, nothing outside one).

    ``lifecycle`` (a :class:`repro_torch.fleet.StopRule`) runs the elastic
    lane lifecycle instead: plateaued lanes stop and the fleet is compacted
    between chunks; a stopped lane's traces repeat its last reward and
    latency (``fleet.run_online_fleet_elastic`` returns the per-lane stop
    epochs and the lane-epochs executed).

    ``mesh`` (a ``launch.mesh.Mesh``) cuts the lanes into one block a slot
    of the mesh's data axes, each on its slot's device; the fleet must be a
    multiple of the data-axis slot count (``ValueError`` naming it
    otherwise).  The draws are fleet-wide (the module docstring's
    contract); ``states`` and ``env_state`` may be this mesh's
    ``sharding.FleetBlocks`` (``FleetCheckpoint.restore(..., mesh=)``); the
    returned states and History are whole, identical on every process of a
    mesh that spans processes (the traces are brought home after each chunk
    with ``sharding.fleet_host``).  Returns (states, History)."""
    agent = _require_agent(agent)
    T = int(T)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if draws is not None and len(draws) != T:
        raise ValueError(f"draws holds {len(draws)} epochs, T is {T}")
    if lifecycle is not None:
        from repro_torch.fleet.lifecycle import run_online_fleet_elastic
        result = run_online_fleet_elastic(
            gen_or_seed, env, agent, states, T, rule=lifecycle,
            updates_per_epoch=updates_per_epoch, explore=explore,
            env_params=env_params, draws=draws, env_state=env_state,
            checkpoint=checkpoint, start_epoch=start_epoch, mesh=mesh)
        return result.states, result.history
    if mesh is not None:
        return _run_meshed(gen_or_seed, env, agent, states, T, updates_per_epoch,
                           explore, env_params, draws, env_state, checkpoint,
                           start_epoch, mesh)
    with lifted():
        gen, _, params, env_state = prepare_fleet(gen_or_seed, env, states,
                                                  env_params, env_state)
        step = make_epoch_step(env, agent, env_params=params,
                               updates_per_epoch=updates_per_epoch,
                               explore=explore)
        parts, done = [], 0
        for n in chunk_schedule(T, None if checkpoint is None else checkpoint.every):
            states, env_state, *traces = run_chunk(
                step, states, env_state, gen, n,
                None if draws is None else draws[done:done + n])
            parts.append(traces)
            done += n
            maybe_check_finite((states, traces[0]),
                               f"run_online_fleet epoch {start_epoch + done}")
            if checkpoint is not None:
                checkpoint.save(start_epoch + done, states, env_state, gen)
        rewards, lats, moved = (torch.cat(x, dim=-1).cpu().numpy()
                                for x in zip(*parts))
        X = env_state.X.cpu().numpy()
    return states, History(rewards=rewards, latencies=lats, moved=moved,
                           final_assignment=X)


def _run_meshed(gen_or_seed, env, agent, states, T, updates_per_epoch, explore,
                env_params, draws, env_state, checkpoint, start_epoch, mesh):
    with lifted():
        gen, F, params, env_state = prepare_fleet(gen_or_seed, env, states,
                                                  env_params, env_state)
        states, env_state, params, _ = shard_fleet(mesh, states, env_state, params,
                                                   env.default_params())
        steps = block_steps(env, agent, params, updates_per_epoch, explore)
        parts, done = [], 0
        for n in chunk_schedule(T, None if checkpoint is None else checkpoint.every):
            states, env_state, traces = run_blocks(
                steps, states, env_state, gen, n, env, agent,
                None if draws is None else draws[done:done + n], updates_per_epoch)
            traces = fleet_host_tree(traces)
            parts.append(traces)
            done += n
            maybe_check_finite((tuple(b.value for b in states.blocks), traces[0]),
                               f"run_online_fleet epoch {start_epoch + done}")
            if checkpoint is not None:
                checkpoint.save(start_epoch + done, states, env_state, gen)
        rewards, lats, moved = (torch.cat(x, dim=-1).numpy() for x in zip(*parts))
        X = fleet_host(FleetBlocks(F, tuple(Block(b.rows, b.device, b.value.X)
                                            for b in env_state.blocks))).numpy()
        states = fleet_host_tree(states, env.device)
    return states, History(rewards=rewards, latencies=lats, moved=moved,
                           final_assignment=X)


def run_online_agent(
    gen_or_seed: torch.Generator | int,
    env,
    agent: Agent,
    state,
    T: int,
    updates_per_epoch: int = 1,
    explore: bool = True,
    env_params=None,
    draws: Sequence[EpochDraws] | None = None,
):
    """One online run of any registry agent over ``T`` decision epochs: the
    reference's single run, here a fleet of one through
    :func:`run_online_fleet`'s loop.

    ``state`` holds one lane (``agent.init_fleet(gen, 1)``, optionally
    pretrained); the env starts from ``env.reset``, as the reference's
    splits its key once for the reset.  ``env_params`` is one scenario
    (``env.default_params()`` when None), never a lane-stacked fleet.
    ``draws`` holds one :class:`EpochDraws` of one lane per epoch; without
    it every draw comes from the generator (or one on ``env.device`` seeded
    with the int).  The run is on ``env.device``.  Returns ``(state,
    History)`` with ``[T]`` traces and an ``[N, M]`` final assignment."""
    fleet = state.shape[0] if isinstance(state, torch.Tensor) else state.fleet
    if fleet != 1:
        raise ValueError(f"run_online_agent runs one lane; the state holds "
                         f"{fleet} (use run_online_fleet)")
    if env_params is not None and params_are_stacked(env, env_params):
        raise ValueError("run_online_agent takes one scenario; env_params is "
                         "lane-stacked (use run_online_fleet)")
    state, hist = run_online_fleet(gen_or_seed, env, agent, state, T,
                                   updates_per_epoch=updates_per_epoch,
                                   explore=explore, env_params=env_params,
                                   draws=draws)
    return state, hist.lane(0)


def greedy_assignment_ddpg(env, cfg: DDPGConfig, state: DDPGState,
                           env_state) -> torch.Tensor:
    """Deploy-time action of a trained fleet (no exploration): each lane's
    critic-best of its ``cfg.k_nn`` exact nearest assignments, ``[F, N,
    M]``.  The reference's takes a key it never draws from."""
    return select_action(state, cfg, env.state_vector(env_state),
                         explore=False, exact_host_knn=True)
