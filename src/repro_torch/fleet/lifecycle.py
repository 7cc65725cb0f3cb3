"""Elastic lane lifecycle: early-stop, compact, and search scenario fleets.

Port of ``repro/fleet/lifecycle.py``.  The fixed-grid fleet runner
(``core/agent.run_online_fleet``) spends the same compute on every lane,
converged or not; this module makes fleet compute budget-aware:

* **Per-lane early stopping** — :class:`StopRule` is a plateau test on the
  windowed reward trace (:func:`plateau_converged`), run at every chunk
  boundary: the epochs are cut every ``rule.check_every`` epochs, or on the
  checkpoint's cadence when one is attached.
* **Lane compaction** — lanes the rule marks done stop paying compute:
  between chunks :func:`compact_lanes` gathers the survivors into a smaller
  fleet (agent states through :func:`take_lanes`, env states, and the
  STACKED leaves of a scenario fleet — broadcast-invariant leaves pass
  through single-copy).  Without a mesh the fleet compacts to exactly its
  live lanes; on a mesh to ``sharding.compaction_size(n_live, mesh)``, the
  gap padded with the most recently stopped "passenger" lanes (``-1`` in
  the lane map), and the compacted carries are cut over the mesh again.
* **Successive-halving scenario search** — :func:`search_scenarios`
  launches a wide fleet of perturbed scenarios, prunes the bottom half at
  each rung by eval reward, refills the freed lanes with fresh
  perturbations and returns a ranked :class:`Leaderboard`.

The draw contract.  The port's fleet draws from one ``torch.Generator``
(the reference carries a PRNG key a lane), and each draw is sized to the
live fleet, so a compacted fleet draws other numbers than the uncompacted
one.  What an elastic run is held to:

* on explicit draws (``draws=``, one ``EpochDraws`` an epoch at this call's
  fleet width; each epoch's step gets the rows of the lanes still running)
  a surviving lane's trajectory equals the fixed-grid run's bit for bit,
  as the reference's does on its keys, and a stopped lane's up to its stop;
* from the generator, (a) with no lane ever stopping the elastic run equals
  ``run_online_fleet`` from the same generator bit for bit, and (b) killed
  and resumed from its own checkpoint (the generator is in it) it equals
  its uninterrupted self bit for bit.  A lane that survives a compaction
  matches the fixed-grid lane in distribution only;
* on a mesh each epoch is drawn at this call's full width and every
  compacted row takes its original lane's draws (``core.agent``'s meshed
  contract), so there a surviving lane equals the meshed fixed-grid run's
  from the same generator too, whatever the mesh.  A compacted snapshot
  resumed is a call of its survivors' width, whose draws are other
  numbers than the uninterrupted run's.

Entry points: ``run_online_fleet(..., lifecycle=StopRule(...))`` for the
drop-in path, :func:`run_online_fleet_elastic` for the full
:class:`ElasticResult`, :func:`restore_elastic` to resume a compacted
snapshot, and ``drl_control --early-stop`` / ``--scenario-search``."""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import map_tensors, named_leaves
from repro_torch.core.agent import (History, _require_agent, block_steps,
                                    chunk_schedule, prepare_fleet, run_blocks,
                                    run_chunk)
from repro_torch.core.api import Agent, EpochDraws, make_epoch_step
from repro_torch.diagnostics import lifted, maybe_check_finite
from repro_torch.dsdps.simulator import lane_params, stack_env_params
from repro_torch.sharding.fleet import compaction_size, fleet_host_tree, shard_fleet


class StopRule(NamedTuple):
    """Plateau test on the windowed per-lane reward.

    A lane is converged when the mean reward of its last ``window`` epochs
    improves on the mean of the ``window`` before that by no more than
    ``rel_tol`` (relative to the reward magnitude) — window means ARE the
    smoother, so single noisy epochs cannot stop a lane.  ``min_epochs``
    lower-bounds how early any lane may stop; ``check_every`` is the chunk
    cadence at which the rule runs when no checkpoint cadence drives the
    chunking."""

    window: int = 8
    rel_tol: float = 0.01
    min_epochs: int = 16
    check_every: int = 8

    @property
    def warmup(self) -> int:
        """Epochs of history the rule needs before it can fire."""
        return max(self.min_epochs, 2 * self.window)


def plateau_converged(recent, rule: StopRule) -> torch.Tensor:
    """Per-lane plateau verdict (bool) over the last ``2 * rule.window``
    epochs: ``recent`` is ``[..., 2*window]`` reward history, float32 (the
    elastic runner slices it from its host trace at each chunk boundary)."""
    recent = torch.as_tensor(recent, dtype=torch.float32)
    W = rule.window
    prev = recent[..., :W].mean(-1)
    last = recent[..., W:].mean(-1)
    scale = torch.clamp(torch.maximum(prev.abs(), last.abs()), min=1e-9)
    return (last - prev) <= rule.rel_tol * scale


# --------------------------------------------------------------------------
# lane gathers over the checkpointer's walk (checkpointer.map_tensors)
# --------------------------------------------------------------------------
def _indexer(idx):
    """``idx`` (any integer sequence) as int64 indices on any device, each
    device's copy made once."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
    on: dict[torch.device, torch.Tensor] = {}

    def at(device) -> torch.Tensor:
        if device not in on:
            on[device] = idx.to(device)
        return on[device]
    return at


def take_lanes(tree, idx):
    """Lanes ``idx`` of every tensor of ``tree`` (dim 0 gathered: a copy),
    its containers rebuilt and its modules given fresh parameters."""
    at = _indexer(idx)
    return map_tensors(lambda x: x.index_select(0, at(x.device)), tree)


def _concat_lanes(a, b):
    return map_tensors(lambda x, y: torch.cat([x, y]), a, b)


def _put_lanes(dst, src, dst_rows, src_rows) -> None:
    """Rows ``src_rows`` of every tensor of ``src`` written, in place, into
    rows ``dst_rows`` of the same tensor of ``dst``."""
    to, frm = _indexer(dst_rows), _indexer(src_rows)
    with torch.no_grad():
        for (_, d), (_, s) in zip(named_leaves(dst), named_leaves(src)):
            d.index_copy_(0, to(d.device), s.index_select(0, frm(s.device)))


def _take_params(params, ref, idx):
    """The lane-stacked fields of ``params`` (one more axis than the single
    scenario ``ref``) gathered at ``idx``; the others pass through."""
    at = _indexer(idx)
    return type(ref)(*(p.index_select(0, at(p.device)) if p.dim() == r.dim() + 1
                       else p for p, r in zip(params, ref)))


def compact_lanes(idx, states, env_state, env_params, ref):
    """Gather lanes ``idx`` of the fleet carries into a smaller fleet.

    ``states`` / ``env_state`` gather their leading fleet axis
    (:func:`take_lanes`); ``env_params`` gathers only its STACKED fields
    against the single-scenario ``ref`` — broadcast-invariant fields pass
    through as the single copy they are.  Returns ``(states, env_state,
    env_params)``."""
    states, env_state = take_lanes(states, idx), take_lanes(env_state, idx)
    if env_params is not None:
        env_params = _take_params(env_params, ref, idx)
    return states, env_state, env_params


@dataclasses.dataclass
class ElasticResult:
    """Outcome of an elastic fleet run, in ORIGINAL lane order.

    ``history`` carries full ``[F, T]`` traces: a lane stopped at epoch e
    repeats its epoch-(e-1) reward/latency from e on (moved pads with 0);
    ``epochs_run[i]`` says where lane i's real trace ends.
    ``executed_lane_epochs`` counts every lane-epoch executed.
    ``lane_ids[i]`` names row i's lane in the RUN THAT STARTED the
    lifecycle — a fresh run numbers 0..F-1; a run resumed from a compacted
    snapshot (:func:`restore_elastic`) keeps the original numbering of the
    surviving lanes."""

    states: Any                     # [F] stacked agent states
    history: History                # [F, T] padded traces
    epochs_run: np.ndarray          # [F] epochs each lane really executed
    executed_lane_epochs: int
    fixed_grid_lane_epochs: int
    lane_ids: np.ndarray = None     # [F] original lane names

    @property
    def savings(self) -> float:
        """Fraction of the fixed grid's lane-epochs NOT executed."""
        return 1.0 - self.executed_lane_epochs / max(
            self.fixed_grid_lane_epochs, 1)


def _draw_rows(draws: EpochDraws, rows) -> EpochDraws:
    at = _indexer(rows)
    return EpochDraws(*(x.index_select(0, at(x.device)) for x in draws))


def run_online_fleet_elastic(
    gen_or_seed: torch.Generator | int,
    env,
    agent: Agent,
    states,
    T: int,
    rule: StopRule | None = None,
    updates_per_epoch: int = 1,
    explore: bool = True,
    env_params=None,
    draws: Sequence[EpochDraws] | None = None,
    env_state=None,
    checkpoint=None,
    start_epoch: int = 0,
    stop_fn: Callable[[np.ndarray, int], np.ndarray] | None = None,
    lane_ids: np.ndarray | None = None,
    mesh=None,
) -> ElasticResult:
    """``run_online_fleet`` with the elastic lane lifecycle.

    The same call surface and per-epoch semantics as the fixed-grid runner
    (``draws`` at this call's fleet width; the draw contract is the module
    docstring's), plus: at every chunk boundary the :class:`StopRule` marks
    plateaued lanes done, their rows are written into a full-width copy of
    the starting states (on the device), and the surviving lanes are
    compacted into a smaller fleet.

    ``checkpoint`` snapshots the COMPACTED carries after each chunk with a
    ``lane_map`` naming each row's original lane (``-1`` for a passenger);
    resume with :func:`restore_elastic`.

    ``mesh`` cuts the lanes over its slots as ``run_online_fleet(...,
    mesh=)`` does; the fleet then compacts to
    ``sharding.compaction_size(n_live, mesh)``, padded with passenger lanes,
    and is cut again.  At each compaction the carries are brought home
    (``sharding.fleet_host_tree``, identically on every process), so the
    lane bookkeeping stays in lockstep across the processes of a spanning
    mesh.

    ``stop_fn(rewards_so_far, t) -> done[n_live]`` overrides the plateau
    test (rows are the live lanes' full ``[n_live, t]`` reward history of
    this call).  ``lane_ids`` names the lanes in the ORIGINAL run's
    numbering — pass the ids :func:`restore_elastic` returns when resuming,
    so lane maps and the result keep referring to the original lanes."""
    agent = _require_agent(agent)
    rule = rule if rule is not None else StopRule()
    T = int(T)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if draws is not None and len(draws) != T:
        raise ValueError(f"draws holds {len(draws)} epochs, T is {T}")
    with lifted():
        states = fleet_host_tree(states, env.device)
        env_state = fleet_host_tree(env_state, env.device)
        gen, F, params, env_state = prepare_fleet(gen_or_seed, env, states,
                                                  env_params, env_state)
        ref = env.default_params()
        ids = (np.arange(F) if lane_ids is None
               else np.asarray(lane_ids, np.int64))  # row -> ORIGINAL lane name
        if ids.shape != (F,):
            raise ValueError(f"lane_ids must be [{F}], got {ids.shape}")
        every = checkpoint.every if checkpoint is not None else rule.check_every

        # -- per-row outputs, in this call's lane order ---------------------
        rewards_buf = np.zeros((F, T), np.float32)
        lats_buf = np.zeros((F, T), np.float32)
        moved_buf = np.zeros((F, T), np.float32)
        epochs_run = np.full(F, T, np.int64)
        final_states = take_lanes(states, np.arange(F))
        final_X = env_state.X.clone()

        orig = np.arange(F)              # compact position -> row in this call
        live = np.ones(F, bool)          # False: a passenger (already captured)
        executed = t = 0

        def whole():
            """The compact carries, whole, on ``env.device``."""
            return (fleet_host_tree(states, env.device),
                    fleet_host_tree(env_state, env.device))

        def capture(pos: np.ndarray) -> None:
            s, e = whole()
            _put_lanes(final_states, s, orig[pos], pos)
            _put_lanes(final_X, e.X, orig[pos], pos)

        def steps():
            if mesh is None:
                return make_epoch_step(env, agent, env_params=params,
                                       updates_per_epoch=updates_per_epoch,
                                       explore=explore)
            return block_steps(env, agent, blocks, updates_per_epoch, explore)

        if mesh is not None:
            states, env_state, blocks, _ = shard_fleet(mesh, states, env_state,
                                                       params, ref)
        step = steps()
        for n in chunk_schedule(T, every):
            if mesh is None:
                chunk = None if draws is None else [
                    d if len(orig) == F else _draw_rows(d, orig)
                    for d in draws[t:t + n]]
                states, env_state, r, l, m = run_chunk(step, states, env_state,
                                                        gen, n, chunk)
                swept = states
            else:
                # every epoch drawn at the call's full width; each compact
                # row takes its original lane's draws
                states, env_state, traces = run_blocks(
                    step, states, env_state, gen, n, env, agent,
                    None if draws is None else draws[t:t + n],
                    updates_per_epoch, rows=orig, width=F)
                r, l, m = fleet_host_tree(traces)
                swept = tuple(b.value for b in states.blocks)
            executed += len(orig) * n
            maybe_check_finite((swept, r),
                               f"run_online_fleet_elastic epoch {start_epoch + t + n}")
            rows = orig[live]
            rewards_buf[rows, t:t + n] = r.cpu().numpy()[live]
            lats_buf[rows, t:t + n] = l.cpu().numpy()[live]
            moved_buf[rows, t:t + n] = m.cpu().numpy()[live]
            t += n
            if checkpoint is not None:
                checkpoint.save(start_epoch + t, states, env_state, gen,
                                lane_map=np.where(live, ids[orig], -1).astype(np.int32))
            if t >= T:
                break

            # -- the stop test at the chunk boundary ------------------------
            if stop_fn is not None:
                done = np.asarray(stop_fn(rewards_buf[rows, :t], t), bool)
            elif t >= rule.warmup:
                done = plateau_converged(
                    rewards_buf[rows, t - 2 * rule.window:t], rule).numpy()
            else:
                continue
            if not done.any():
                continue
            pos = np.flatnonzero(live)[done]
            capture(pos)
            stopped = orig[pos]
            epochs_run[stopped] = t
            rewards_buf[stopped, t:] = rewards_buf[stopped, t - 1:t]
            lats_buf[stopped, t:] = lats_buf[stopped, t - 1:t]
            moved_buf[stopped, t:] = 0.0
            live[pos] = False

            # -- compaction -------------------------------------------------
            n_live = int(live.sum())
            if n_live == 0:
                break
            target = compaction_size(n_live, mesh)
            if target < len(orig):
                keep = np.flatnonzero(live)
                if target > n_live:      # pad with the most recent passengers
                    passengers = np.flatnonzero(~live)[::-1][:target - n_live]
                    keep = np.sort(np.concatenate([keep, passengers]))
                if mesh is not None:
                    states, env_state = whole()
                states, env_state, params = compact_lanes(keep, states, env_state,
                                                          params, ref)
                orig, live = orig[keep], live[keep]
                if mesh is not None:
                    states, env_state, blocks, _ = shard_fleet(
                        mesh, states, env_state, params, ref)
                step = steps()
        if live.any():                   # lanes still running at the horizon
            capture(np.flatnonzero(live))
        X = final_X.cpu().numpy()
    history = History(rewards=rewards_buf, latencies=lats_buf,
                      moved=moved_buf, final_assignment=X)
    return ElasticResult(states=final_states, history=history,
                         epochs_run=epochs_run, executed_lane_epochs=executed,
                         fixed_grid_lane_epochs=F * T, lane_ids=ids)


def restore_elastic(checkpoint, states_like, env_state_like, gen_like,
                    env_params=None, ref=None, epoch: int | None = None,
                    mesh=None):
    """Restore a COMPACTED elastic-lifecycle snapshot for resumption.

    The snapshot's width is its lane map's, read from the manifest; the
    templates (built for the original, full-width fleet) are cut to it
    with :func:`take_lanes` before the restore, which checks every leaf's
    shape.  Rows of the lane map that are ``-1`` (passenger lanes of a
    meshed run; none without a mesh) are dropped.  Given the original
    run's lane-stacked ``env_params`` and the single-scenario ``ref``, the
    surviving lanes' scenario rows are gathered (broadcast-invariant
    fields pass through single-copy).

    The carries come back whole whatever ``mesh`` is, as the reference's
    come back as host arrays onto a mesh that spans processes: dropping
    the passenger rows changes the fleet's width, so
    ``run_online_fleet_elastic(..., mesh=)`` cuts them over the mesh
    afresh.  A snapshot written by several processes
    (``step_N/proc_P/``) restores on any number of them.

    Returns ``(epoch, states, env_state, gen, env_params, lane_ids)``; feed
    them back into :func:`run_online_fleet_elastic` with
    ``start_epoch=epoch`` and ``lane_ids=lane_ids``."""
    if env_params is not None and ref is None:
        raise ValueError("restoring with env_params= needs ref= (the env's "
                         "default_params()) to tell stacked fields from "
                         "invariant ones")
    checkpoint.wait()
    epoch = checkpoint.latest_epoch() if epoch is None else epoch
    if epoch is None:
        raise FileNotFoundError(f"no fleet checkpoints in {checkpoint.directory}")
    entry = checkpoint._lanes_entry(epoch)
    if entry is None:
        raise ValueError(f"the snapshot of epoch {epoch} in "
                         f"{checkpoint.directory} has no lane map; restore it "
                         "with FleetCheckpoint.restore")
    width = np.arange(entry["shape"][0])
    del mesh                             # whole carries onto any mesh
    epoch, states, env_state, gen, lane_map = checkpoint.restore(
        take_lanes(states_like, width), take_lanes(env_state_like, width),
        gen_like, epoch=epoch, with_lane_map=True)
    rows = np.flatnonzero(lane_map >= 0)
    if rows.size < width.size:
        states, env_state = take_lanes(states, rows), take_lanes(env_state, rows)
    ids = lane_map[rows].astype(np.int64)
    if env_params is not None:
        env_params = _take_params(env_params, ref, ids)
    return epoch, states, env_state, gen, env_params, ids


# --------------------------------------------------------------------------
# Successive-halving scenario search
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ScenarioEntry:
    """One candidate scenario's search record."""

    cand: int            # candidate id (launch order)
    rung: int            # rungs completed (1-based)
    epochs: int          # cumulative training epochs this candidate got
    score: float         # eval reward: mean of its last eval_window epochs
    survived: bool       # still in the fleet after its last cut


@dataclasses.dataclass
class Leaderboard:
    """Ranked outcome of :func:`search_scenarios` (best score first).

    ``params[cand]`` holds each candidate's single-scenario params —
    re-stack the top entries with ``stack_env_params`` to train a full
    fleet on the curated set."""

    entries: list[ScenarioEntry]
    rungs: tuple[int, ...]
    fleet: int
    total_lane_epochs: int
    params: dict[int, Any]

    def to_json(self) -> dict:
        return {
            "rungs": list(self.rungs),
            "fleet": self.fleet,
            "total_lane_epochs": self.total_lane_epochs,
            "leaderboard": [dataclasses.asdict(e) for e in self.entries],
        }

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=2))
        return path


def search_scenarios(
    env,
    agent: Agent,
    scenario: str = "mixed",
    perturb: Callable[[torch.Generator], Any] | None = None,
    fleet: int = 8,
    rungs: tuple[int, ...] = (16, 16, 32),
    eval_window: int = 8,
    updates_per_epoch: int = 1,
    explore: bool = True,
    refill: bool = True,
    seed: int = 0,
) -> Leaderboard:
    """Successive-halving search over perturbed scenarios.

    A ``fleet``-wide candidate set seeded from the named scenario builder
    (``dsdps.scenarios.build_for(env, scenario, fleet)``) trains through
    the rungs: after each rung every lane is scored by eval reward (mean
    training reward over its last ``eval_window`` epochs — higher is
    better), the bottom half is pruned via :func:`compact_lanes`, and —
    with ``refill=True`` — the freed lanes are refilled with fresh
    perturbations (``perturb(gen) -> params``, default
    ``dsdps.scenarios.perturb_sampler(env)``).  Survivors carry their agent
    and env states across rungs; refills start fresh.  Every draw (agent
    init, epochs, refills) comes from one generator on ``env.device``
    seeded with ``seed``.

    Returns a :class:`Leaderboard` ranked by score, holding every
    candidate ever launched plus its params."""
    from repro_torch.dsdps import scenarios as scen
    if fleet < 2:
        raise ValueError(f"search needs fleet >= 2, got {fleet}")
    ref = env.default_params()
    if perturb is None:
        perturb = scen.perturb_sampler(env)
    gen = torch.Generator(device=env.device).manual_seed(seed)

    stacked = scen.build_for(env, scenario, fleet)
    cand_params = {i: lane_params(stacked, ref, i) for i in range(fleet)}
    current = list(range(fleet))
    next_id = fleet
    states = agent.init_fleet(gen, fleet, env.device, env_params=stacked)
    env_state = env.reset(fleet, stacked)

    entries: dict[int, ScenarioEntry] = {}
    epochs_done = {c: 0 for c in current}
    total = 0
    for r, n in enumerate(rungs):
        n = int(n)
        stacked = stack_env_params([cand_params[c] for c in current])
        step = make_epoch_step(env, agent, env_params=stacked,
                               updates_per_epoch=updates_per_epoch,
                               explore=explore)
        states, env_state, rewards, _, _ = run_chunk(step, states, env_state,
                                                     gen, n)
        total += len(current) * n
        scores = rewards.cpu().numpy()[:, -min(eval_window, n):].mean(axis=1)
        for i, c in enumerate(current):
            epochs_done[c] += n
            entries[c] = ScenarioEntry(cand=c, rung=r + 1,
                                       epochs=epochs_done[c],
                                       score=float(scores[i]), survived=True)
        if r == len(rungs) - 1:
            break

        # -- the halving cut ------------------------------------------------
        keep = np.sort(np.argsort(-scores)[:max(1, len(current) // 2)])
        for i, c in enumerate(current):
            if i not in keep:
                entries[c] = dataclasses.replace(entries[c], survived=False)
        states, env_state, _ = compact_lanes(keep, states, env_state, None, ref)
        current = [current[i] for i in keep]

        if refill:
            new_ids = list(range(next_id, next_id + fleet - len(current)))
            for c in new_ids:
                cand_params[c] = perturb(gen)
            next_id += len(new_ids)
            new_stacked = stack_env_params([cand_params[c] for c in new_ids])
            states = _concat_lanes(states, agent.init_fleet(
                gen, len(new_ids), env.device, env_params=new_stacked))
            env_state = _concat_lanes(env_state,
                                      env.reset(len(new_ids), new_stacked))
            current += new_ids
            epochs_done.update({c: 0 for c in new_ids})

    ranked = sorted(entries.values(), key=lambda e: -e.score)
    return Leaderboard(entries=ranked, rungs=tuple(int(n) for n in rungs),
                       fleet=fleet, total_lane_epochs=total,
                       params=cand_params)
