"""The paper's control loop as a launcher: train a registry agent's fleet
on a DSDPS topology or on the expert-placement env on the GPU and report
the schedule.

Port of ``repro/launch/drl_control.py``: build the env (one topology,
``--app structural``: the chain, diamond and wide fan-out DAGs padded into
one envelope, or ``--app placement``: Jamba-1.5-large's 16 experts on 16
devices, ``core/placement.py``), initialize ``--fleet`` lanes of
``--agent`` (``ddpg``, ``dqn``, ``graph_policy``, ``model_based``,
``round_robin``, ``stream_ac``, ``stream_q``), each under its own scenario
when ``--scenario`` names a heterogeneous fleet (``uniform``,
``one_slow_machine``, ``diurnal_rate``, ``high_noise``, ``mixed``, and on
``structural`` ``dag_shapes``, a DAG per lane; on ``placement``
``uniform``, ``one_slow_device``, ``skewed_routing``, ``traffic_surge``,
``mixed``; the model-based baseline
profiles and fits the lane's cluster), pretrain DDPG
lanes offline on random transitions, run ``--epochs`` online decision
epochs, and score every lane's final assignment against round-robin under
that lane's scenario.  ``--serve N`` then serves N synthetic decision
requests from the best lane's trained policy through the batched serving
control plane (``serve/control.py``, ``launch/serve_control.py``), every
training lane's scenario registered as a cluster.  ``--checkpoint-dir``
saves the fleet's carries every ``--checkpoint-every`` epochs
(``checkpoint/fleet.py``); ``--resume`` continues from the newest of them,
without offline pretraining, since the restored lanes carry their replay
and nets.  ``--early-stop`` runs the elastic lane lifecycle
(``fleet/lifecycle.py``): lanes whose windowed reward plateaus stop and the
fleet compacts, and ``--resume`` then continues a compacted snapshot
through ``restore_elastic``.  ``--scenario-search`` trains no fleet: it
runs a successive-halving search over perturbed scenarios (``--fleet``
candidates seeded from ``--scenario``, default ``mixed``, rungs of
``--search-rungs`` epochs) and writes the ranked leaderboard to
``--search-json``.  ``--guards`` runs the online phase under
``diagnostics.guards(transfer="log")`` and prints the synchronizing calls
per steady-state epoch with their sites: "log", not the reference's
"disallow", since whether the port's epochs wait on the device is what is
being measured, and a guard that aborts the first such call would measure
nothing.

``--sharded`` cuts the fleet over this process's slots
(``launch.mesh.make_fleet_mesh``: one a visible card, or
``REPRO_FLEET_SLOTS`` on ``--device``) and ``--distributed`` joins a
multi-process job first (``launch.mesh.init_distributed``, before any CUDA
call; the coordinates from ``REPRO_COORDINATOR``, ``REPRO_NUM_PROCESSES``,
``REPRO_PROCESS_ID``) and cuts it over every process's slots, each process
running this same command and every rank but 0 silent
(``repro_torch.launch.multihost`` spawns such jobs on one host).  A fleet
the mesh does not divide, after a resume too, runs un-meshed on the same
device, with a printed line saying so.  ``--resume`` restores onto the
mesh, through the lane map when there is one.  ``--save-history PATH``
writes the History and the per-lane latencies (rank 0) as ``.npz``.

  PYTHONPATH=src python -m repro_torch.launch.drl_control --app cq_large \\
      --fleet 8 --offline 2000 --epochs 300
  PYTHONPATH=src python -m repro_torch.launch.drl_control --app cq_large \\
      --agent model_based --scenario one_slow_machine --fleet 8
  PYTHONPATH=src python -m repro_torch.launch.drl_control --device cpu \\
      --app cq_small --fleet 2 --offline 50 --offline-updates 5 --epochs 5
  PYTHONPATH=src python -m repro_torch.launch.drl_control --app cq_large \\
      --fleet 8 --scenario mixed --serve 256
  PYTHONPATH=src python -m repro_torch.launch.drl_control --app structural \\
      --agent graph_policy --scenario dag_shapes --fleet 6
  PYTHONPATH=src python -m repro_torch.launch.drl_control --app placement \\
      --scenario mixed --fleet 8 --offline 1000 --offline-updates 100 \\
      --epochs 50
  PYTHONPATH=src python -m repro_torch.launch.drl_control --app cq_large \\
      --fleet 8 --epochs 300 --checkpoint-dir ckpt --checkpoint-every 50 \\
      [--resume] [--early-stop]
  PYTHONPATH=src python -m repro_torch.launch.drl_control --app cq_large \\
      --fleet 8 --offline 1000 --offline-updates 100 --epochs 50 --guards
  PYTHONPATH=src python -m repro_torch.launch.drl_control --app cq_small \\
      --scenario-search --fleet 8 --search-rungs 16,16,32
  REPRO_FLEET_SLOTS=2 PYTHONPATH=src python -m repro_torch.launch.drl_control \\
      --device cpu --app cq_small --fleet 4 --offline 50 --offline-updates 5 \\
      --epochs 8 --sharded

Runs on CUDA unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises."""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import FleetCheckpoint
from repro_torch.core import (agent_names, convert, jamba_placement_env,
                              make_agent, run_online_fleet)
from repro_torch.core import ddpg as ddpg_lib
from repro_torch.core.placement import PLACEMENT_SCENARIOS
from repro_torch.device import resolve_device
from repro_torch.diagnostics import guards as guard_region
from repro_torch.dsdps import (SchedulingEnv, StructuralSchedulingEnv, apps,
                               lane_params, scenarios)
from repro_torch.dsdps.apps import default_workload
from repro_torch.fleet import (restore_elastic, run_online_fleet_elastic,
                               search_scenarios)
from repro_torch.launch.mesh import (init_distributed, make_fleet_mesh,
                                     process_index)
from repro_torch.sharding import fleet_size

APPS = (*apps.ALL_APPS, "placement", "structural")


def build_env(app: str, device):
    if app == "placement":
        return jamba_placement_env(device=device)
    if app == "structural":
        # chain / diamond / wide fan-out padded into one envelope: the
        # DAG-shape fleet (--scenario dag_shapes gives each lane its own)
        return StructuralSchedulingEnv(apps.structural_topologies(),
                                       device=device)
    topo = apps.ALL_APPS[app]()
    return SchedulingEnv(topo, default_workload(topo), device=device)


def refusal(app: str, agent: str, offline: int = 0, serve: int = 0,
            fleet: int = 4, checkpoint_dir=None, resume: bool = False,
            early_stop: bool = False, scenario_search: bool = False,
            sharded: bool = False, distributed: bool = False) -> str | None:
    """Why the launcher refuses ``agent`` on ``app`` with these options, or
    None: setups that would crash on the env, as the reference's launcher
    refuses them; serving or a scenario search in a multi-process job (both
    run single-process); a scenario search sharded, with checkpoints, a
    resume or early stopping (it runs its own rung fleets), or with fewer
    than 2 candidates; a resume without a checkpoint directory, or from an
    elastic-lifecycle directory (its snapshots hold a compacted fleet and
    a lane map) without ``early_stop``."""
    if distributed:
        if serve:
            return ("--serve drives a single-process control plane; run it "
                    "without --distributed")
        if scenario_search:
            return ("--scenario-search runs its own single-process rung "
                    "fleets; drop --distributed")
    if app == "placement":
        if agent == "model_based":
            return ("model_based profiles a DSDPS cluster; use it with the "
                    "Storm apps")
        if agent == "graph_policy":
            return ("graph_policy message-passes over a topology DAG; use it "
                    "with the Storm apps or --app structural")
        if serve:
            return ("--serve drives the DSDPS control plane; use it with the "
                    "Storm apps")
    if app == "structural":
        if agent == "model_based":
            return ("model_based fits its latency model on random "
                    "assignments, which a padded envelope does not define; "
                    "use it with the Storm apps")
        if agent == "ddpg" and offline > 0:
            return ("offline pretraining draws random assignments, which a "
                    "padded envelope does not define (random rows on padded "
                    "executors); --offline 0 runs DDPG on --app structural")
        if serve:
            return ("--serve registers plain EnvParams clusters of one "
                    "topology; use it with a Storm app, not --app structural")
    if serve and agent not in ("ddpg", "round_robin"):
        return (f"--serve needs an agent that decides from (s_vec, cluster "
                f"params) alone; {agent}'s select reads the live EnvState "
                f"(see docs/serving.md)")
    if scenario_search:
        for flag, on in (("--sharded", sharded),
                         ("--checkpoint-dir", checkpoint_dir is not None),
                         ("--resume", resume), ("--early-stop", early_stop)):
            if on:
                return (f"--scenario-search does not support {flag}: the "
                        f"search runs its own un-sharded, un-checkpointed rung "
                        f"fleets "
                        f"(--offline/--epochs are ignored too — rung lengths "
                        f"come from --search-rungs)")
        if fleet < 2:
            return "--scenario-search needs --fleet >= 2"
    if resume:
        if checkpoint_dir is None:
            return "--resume needs --checkpoint-dir (a checkpoint directory)"
        if (not early_stop and
                FleetCheckpoint(checkpoint_dir, use_async=False).has_lane_map()):
            return (f"{checkpoint_dir} holds elastic-lifecycle (compacted) "
                    f"snapshots with a lane map; resume with --early-stop")
    return None


def nominal_load(env, params):
    """The load a scenario of ``env`` scores under: a DSDPS env's spout base
    rates, the placement env's per-expert base load."""
    return params.base_load if env.family == "placement" else params.base_rates


def run(app: str = "cq_small", agent: str = "ddpg", fleet: int = 4,
        offline: int = 2000, offline_updates: int = 500, epochs: int = 300,
        k: int = 12, seed: int = 0,
        device: str | torch.device | None = None,
        scenario: str | None = None,
        broadcast_invariant: bool = False, env=None,
        checkpoint_dir=None, checkpoint_every: int = 50,
        resume: bool = False, early_stop: bool = False,
        guards: bool = False, scenario_search: bool = False,
        search_rungs: tuple[int, ...] = (16, 16, 32),
        stop_fn=None, sharded: bool = False,
        distributed: bool = False) -> dict | None:
    """Run the loop on ``env`` (default ``build_env(app, device)``); returns
    a dict with the env, the scenario fleet (None
    without ``scenario``), the agent, the trained states, the History,
    per-lane final and round-robin latencies (ms, each under the lane's
    scenario), the index of the best lane (lowest final/round-robin), the
    wall seconds of each phase (``init`` holds the model-based fit;
    ``flush``, with a checkpoint, the wait for its last write), the epoch
    the online phase started at, the lane-epochs it executed and their
    rate per second.  ``k`` sizes DDPG's K-NN beam and ``offline``
    pretrains DDPG lanes; the other agents ignore both.

    ``checkpoint_dir`` saves the carries every ``checkpoint_every`` epochs;
    ``resume`` restores the newest of them, skips offline pretraining and
    runs the epochs left up to ``epochs``; the History then holds those
    alone.  When none are left it prints so and returns None.

    ``early_stop`` runs the elastic lane lifecycle under the default
    ``StopRule`` (``stop_fn`` overrides its test, as
    ``run_online_fleet_elastic``'s does); the result then holds the
    ``ElasticResult`` as ``elastic``, the History in the original lane
    order, and with ``resume`` of a compacted snapshot only its surviving
    lanes (``lane_ids``).  ``guards`` runs the online phase under
    ``diagnostics.guards(transfer="log")``; its ``GuardState`` is returned
    as ``guards``.  ``scenario_search`` trains no fleet: it runs
    ``search_scenarios`` over ``fleet`` candidates seeded from
    ``scenario`` (default ``mixed``) with rungs of ``search_rungs`` epochs
    and returns the env, the agent, the ``Leaderboard`` and the wall
    seconds.  A setup the launcher refuses (:func:`refusal`) raises
    ``ValueError``.

    ``sharded`` cuts the fleet over this process's slots, ``distributed``
    over every process's of a job joined with
    ``launch.mesh.init_distributed``; the result then holds the mesh
    (``mesh``; None when the fleet does not divide it, after a resume too:
    the run goes on un-meshed, with a printed line) and the checkpoint's
    save walls (``save_seconds``)."""
    why = refusal(app, agent, offline, fleet=fleet, checkpoint_dir=checkpoint_dir,
                  resume=resume, early_stop=early_stop,
                  scenario_search=scenario_search, sharded=sharded,
                  distributed=distributed)
    if why is not None:
        raise ValueError(why)
    if distributed:
        init_distributed()                  # a no-op when already joined
    dev = resolve_device(device)

    def now() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    seconds = {}
    t0 = now()
    env = build_env(app, dev) if env is None else env
    ag = make_agent(agent, env, **({"k_nn": k} if agent == "ddpg" else {}))
    if scenario_search:
        lb = search_scenarios(env, ag, scenario=scenario or "mixed", fleet=fleet,
                              rungs=tuple(search_rungs), seed=seed)
        seconds["search"] = now() - t0
        return dict(env=env, agent=ag, leaderboard=lb, seconds=seconds)
    env_params = (scenarios.build_for(env, scenario, fleet,
                                      broadcast_invariant=broadcast_invariant)
                  if scenario else None)
    # lanes initialize under their own scenario: the model-based baseline
    # profiles and fits the lane's cluster, not the nominal one
    states = ag.init_fleet(torch.Generator(device=dev).manual_seed(seed),
                           fleet, dev, env_params=env_params)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    mesh = (make_fleet_mesh(spanning=distributed, device=dev)
            if sharded or distributed else None)
    mesh = divides(mesh, fleet, f"--fleet {fleet}")
    ck = (FleetCheckpoint(checkpoint_dir, every=checkpoint_every)
          if checkpoint_dir is not None else None)
    elastic = g = lane_ids = None
    try:
        env_state, start = None, 0
        if resume and ck.latest_epoch() is not None:
            like = (states, env.reset(fleet, env_params), gen)
            if ck.has_lane_map():
                # a compacted elastic snapshot: its surviving lanes, and
                # their rows of the scenario fleet
                start, states, env_state, gen, env_params, lane_ids = \
                    restore_elastic(ck, *like, env_params=env_params,
                                    ref=env.default_params(), mesh=mesh)
                mesh = divides(mesh, len(lane_ids),
                               f"{len(lane_ids)} surviving lane(s)")
            else:
                start, states, env_state, gen = ck.restore(*like, mesh=mesh)
            if start >= epochs:
                print(f"checkpoint already at epoch {start} >= --epochs "
                      f"{epochs}; nothing left to run")
                return None
        t1 = now()
        seconds["init"] = t1 - t0
        # offline pretraining seeds a fresh run alone: restored lanes
        # already carry their replay buffers and trained networks
        if agent == "ddpg" and offline > 0 and env_state is None:
            states = ddpg_lib.offline_pretrain(
                states, ag.cfg, env, n_samples=offline,
                n_updates=offline_updates, env_params=env_params,
                gen=torch.Generator(device=dev).manual_seed(seed + 1))
        t2 = now()
        seconds["offline"] = t2 - t1
        region = (guard_region(transfer="log", label="drl_control") if guards
                  else contextlib.nullcontext())
        with region as g:
            if early_stop:
                elastic = run_online_fleet_elastic(
                    gen, env, ag, states, epochs - start,
                    env_params=env_params, env_state=env_state, checkpoint=ck,
                    start_epoch=start, stop_fn=stop_fn, lane_ids=lane_ids,
                    mesh=mesh)
                states, hist = elastic.states, elastic.history
                executed = elastic.executed_lane_epochs
            else:
                states, hist = run_online_fleet(
                    gen, env, ag, states, T=epochs - start, env_params=env_params,
                    env_state=env_state, checkpoint=ck, start_epoch=start,
                    mesh=mesh)
                executed = hist.rewards.size
        t3 = now()
        seconds["online"] = t3 - t2
    finally:
        if ck is not None:
            ck.close()
    if ck is not None:
        seconds["flush"] = now() - t3
        t3 = now()

    # score every lane under the scenario it ran, noise-free, round-robin
    # too, so the improvement compares like with like per lane
    lanes = hist.final_assignment.shape[0]
    p = env.default_params() if env_params is None else env_params
    w = nominal_load(env, p).expand(lanes, -1)
    X = torch.as_tensor(hist.final_assignment, device=dev)
    X_rr = env.round_robin_assignment().expand(lanes, env.N, env.M)
    finals = env.evaluate(X, w, params=p).cpu().numpy().astype(np.float64)
    rrs = env.evaluate(X_rr, w, params=p).cpu().numpy().astype(np.float64)
    seconds["score"] = now() - t3
    best = int((finals / rrs).argmin())
    return dict(env=env, env_params=env_params, agent=ag, states=states,
                history=hist, finals=finals, rrs=rrs, best=best,
                seconds=seconds, start_epoch=start, elastic=elastic, guards=g,
                lane_ids=lane_ids, lane_epochs=executed,
                lane_epochs_per_s=executed / seconds["online"], mesh=mesh,
                save_seconds=[] if ck is None else ck.save_seconds)


def divides(mesh, lanes: int, what: str):
    """``mesh``, or None (printing why) when ``lanes`` do not divide its
    data-axis slots: the elastic degradation of a run resumed where the
    slot count no longer divides the fleet, which then runs un-meshed on
    the same device rather than dying in ``shard_fleet``'s check."""
    if mesh is not None and lanes % fleet_size(mesh):
        print(f"{what} does not divide the {fleet_size(mesh)} data-axis "
              f"devices; falling back to the un-sharded runner")
        return None
    return mesh


def serve_trained(res: dict, n_requests: int, seed: int = 0) -> dict:
    """Serve ``n_requests`` synthetic decisions from ``run``'s result: the
    best lane's trained policy answers placement requests, each training
    lane's scenario is a registered cluster, and the rate_control /
    auto_tune planes ride along.  Returns the service, the served requests
    and the per-kind latency stats."""
    from repro_torch.launch.serve_control import (build_service,
                                                  synthetic_requests)
    env, agent, states, best = (res["env"], res["agent"], res["states"],
                                res["best"])
    env_params = res["env_params"]
    if isinstance(states, torch.Tensor):
        best_state = states[best:best + 1].clone()
    else:
        best_state = convert.ddpg_state_from_numpy(
            convert.lane_arrays(convert.ddpg_state_to_numpy(states), best),
            env.device)
    svc = build_service(env, seed=seed, n_slots=min(8, n_requests),
                        placement_agent=agent, placement_state=best_state)
    for f in range(len(res["finals"])):
        svc.register_cluster(
            f"lane-{f}",
            lane_params(env_params, env.default_params(), f)
            if env_params is not None else None)
    for r in synthetic_requests(env, svc, n_requests, seed=seed):
        svc.submit(r)
    served = svc.run()
    if len(served) != n_requests:
        raise RuntimeError(f"served {len(served)} of {n_requests} requests")
    return dict(service=svc, served=served, stats=svc.decision_stats())


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", default="cq_small", choices=list(APPS),
                    help="one Storm topology, 'placement': the expert-"
                         "placement env (16 experts on 16 devices), or "
                         "'structural': the envelope-padded DAG-shape env "
                         "over apps.STRUCTURAL_APPS (pairs with --agent "
                         "graph_policy and --scenario dag_shapes)")
    ap.add_argument("--agent", default="ddpg", choices=list(agent_names()),
                    help="registered control policy (core.api.make_agent)")
    ap.add_argument("--scenario", default=None,
                    choices=sorted({**scenarios.SCENARIOS,
                                    **scenarios.STRUCTURAL_SCENARIOS,
                                    **PLACEMENT_SCENARIOS}),
                    help="heterogeneous params fleet, one scenario per lane, "
                         "instead of a pure seed sweep (EnvParams for the "
                         "DSDPS apps, PlacementParams for --app placement; "
                         "dag_shapes, a DAG per lane, needs --app "
                         "structural)")
    ap.add_argument("--broadcast-invariant", action="store_true",
                    help="keep scenario-invariant params fields single-copy")
    ap.add_argument("--offline", type=int, default=2000,
                    help="offline random-action samples per lane "
                         "(paper: 10,000; ddpg only)")
    ap.add_argument("--offline-updates", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--fleet", type=int, default=4,
                    help="independent online-learning lanes, batched")
    ap.add_argument("--k", type=int, default=12,
                    help="K-NN beam width (ddpg only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--serve", type=int, default=0, metavar="N",
                    help="after training, serve N synthetic decision "
                         "requests from the best lane's trained policy "
                         "through the batched serving control plane — "
                         "every training lane's scenario becomes a "
                         "registered cluster (repro_torch.serve.control)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for asynchronous, atomic fleet "
                         "checkpoints (repro_torch.checkpoint.FleetCheckpoint)")
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="checkpoint cadence in decision epochs")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in "
                         "--checkpoint-dir instead of starting fresh (a "
                         "compacted elastic snapshot needs --early-stop)")
    ap.add_argument("--early-stop", action="store_true",
                    help="elastic lane lifecycle: stop lanes whose windowed "
                         "reward plateaus and compact the fleet, so converged "
                         "scenarios stop paying compute "
                         "(repro_torch.fleet.lifecycle)")
    ap.add_argument("--scenario-search", action="store_true",
                    help="successive-halving search over perturbed "
                         "scenarios instead of training: --fleet candidates "
                         "seeded from --scenario (default mixed), bottom "
                         "half pruned at each rung, freed lanes refilled; "
                         "prints and saves the ranked leaderboard")
    ap.add_argument("--search-rungs", default="16,16,32",
                    help="comma-separated epochs per successive-halving rung")
    ap.add_argument("--search-json", default="artifacts/scenario_search.json",
                    help="leaderboard artifact path for --scenario-search")
    ap.add_argument("--sharded", action="store_true",
                    help="cut the fleet over this process's slots "
                         "(launch.mesh.make_fleet_mesh: one a visible card, "
                         "or REPRO_FLEET_SLOTS on --device); --fleet must be "
                         "a multiple of the slot count")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process fleet: join a torch.distributed job "
                         "(gloo; coordinator and rank from REPRO_COORDINATOR / "
                         "REPRO_NUM_PROCESSES / REPRO_PROCESS_ID, see "
                         "launch.mesh.init_distributed) and cut the fleet over "
                         "every process's slots; every process runs this same "
                         "command (repro_torch.launch.multihost spawns "
                         "localhost jobs)")
    ap.add_argument("--save-history", default=None, metavar="PATH",
                    help="write the History and the per-lane final and "
                         "round-robin latencies to PATH (.npz, rank 0)")
    ap.add_argument("--guards", action="store_true",
                    help="run the online phase under the runtime guards "
                         "(repro_torch.diagnostics, transfer='log'): count "
                         "the synchronizing calls of each steady-state epoch "
                         "by site, sweep the carries for non-finite values "
                         "at every chunk boundary")
    args = ap.parse_args(argv)
    if args.distributed and not (args.serve or args.scenario_search):
        # before any CUDA call; a no-op without a coordinator
        init_distributed()
        if process_index() != 0:
            # one report a job: the other ranks run the same program and
            # stay quiet (their results are identical by construction)
            sys.stdout = open(os.devnull, "w")
    if args.fleet < 1:
        ap.error("--fleet must be >= 1")
    if args.serve < 0:
        ap.error("--serve must be >= 0")
    try:
        rungs = tuple(int(x) for x in args.search_rungs.split(",") if x)
    except ValueError:
        rungs = ()
    if not rungs or min(rungs) < 1:
        ap.error(f"--search-rungs must be positive integers, got "
                 f"{args.search_rungs!r}")
    why = refusal(args.app, args.agent, args.offline, args.serve,
                  fleet=args.fleet, checkpoint_dir=args.checkpoint_dir,
                  resume=args.resume, early_stop=args.early_stop,
                  scenario_search=args.scenario_search, sharded=args.sharded,
                  distributed=args.distributed)
    if why is not None:
        ap.error(why)
    env = build_env(args.app, resolve_device(args.device))
    if args.scenario and args.scenario not in scenarios.scenario_names(env):
        ap.error(f"scenario {args.scenario!r} is not defined for "
                 f"--app {args.app}; known: {scenarios.scenario_names(env)}")
    kw = dict(app=args.app, agent=args.agent, fleet=args.fleet, k=args.k,
              seed=args.seed, device=args.device, scenario=args.scenario,
              env=env)
    if args.scenario_search:
        print(f"successive-halving scenario search: {args.fleet} candidates "
              f"seeded from {args.scenario or 'mixed'!r}, rungs {rungs} ...")
        res = run(**kw, scenario_search=True, search_rungs=rungs)
        lb = res["leaderboard"]
        print("\nrank  cand  rung  epochs  eval_reward  survived")
        for rank, e in enumerate(lb.entries):
            print(f"{rank:4d}  {e.cand:4d}  {e.rung:4d}  {e.epochs:6d}  "
                  f"{e.score:11.4f}  {e.survived}")
        print(f"\ntotal lane-epochs executed: {lb.total_lane_epochs} "
              f"(fixed grid over every candidate would be "
              f"{len(lb.entries) * sum(rungs)})")
        print(f"wrote {lb.save(args.search_json)}")
        return res
    scen = f" ({args.scenario} scenario fleet)" if args.scenario else ""
    pre = (f"{args.offline} offline samples, {args.offline_updates} offline "
           f"updates, " if args.agent == "ddpg" else "")
    stop = " with per-lane early stopping" if args.early_stop else ""
    print(f"{args.agent} fleet of {args.fleet} on {args.app}{scen}: "
          f"{pre}{args.epochs} online epochs{stop} ...")
    res = run(**kw, offline=args.offline, offline_updates=args.offline_updates,
              epochs=args.epochs, broadcast_invariant=args.broadcast_invariant,
              checkpoint_dir=args.checkpoint_dir,
              checkpoint_every=args.checkpoint_every, resume=args.resume,
              early_stop=args.early_stop, guards=args.guards,
              sharded=args.sharded, distributed=args.distributed)
    if res is None:
        return None
    if res["mesh"] is not None:
        print(f"online learning sharded over {res['mesh'].size} slot(s) of "
              f"{len({s.process for s in res['mesh'].slots.flat})} process(es) "
              f"from epoch {res['start_epoch']}: "
              f"{res['lane_epochs_per_s']:.1f} lane-epochs/s")
    if res["save_seconds"]:
        print(f"checkpoint saves: {len(res['save_seconds'])}, ms each "
              + ", ".join(f"{1e3 * x:.3f}" for x in res["save_seconds"]))
    if res["lane_ids"] is not None:
        print(f"resumed a compacted elastic fleet from epoch "
              f"{res['start_epoch']}: surviving lanes "
              f"{res['lane_ids'].tolist()}")
    if res["elastic"] is not None:
        e = res["elastic"]
        print(f"early stopping: per-lane epochs {e.epochs_run.tolist()} — "
              f"{e.executed_lane_epochs} lane-epochs executed vs "
              f"{e.fixed_grid_lane_epochs} fixed-grid ({e.savings:.0%} saved)")
    if res["guards"] is not None:
        print(f"guards: {res['guards'].sync_report()}; no non-finite carries")
    finals, rrs, best = res["finals"], res["rrs"], res["best"]
    print(f"\nfinal latency {finals.mean():.3f} ± {finals.std():.3f} ms "
          f"over {len(finals)} lanes "
          f"(best lane {best}: {finals[best]:.3f} ms)   "
          f"round-robin {rrs.mean():.3f} ms   "
          f"improvement {1 - finals.mean() / rrs.mean():.1%} mean / "
          f"{1 - finals[best] / rrs[best]:.1%} best")
    print("best assignment (executor -> machine):",
          res["history"].final_assignment[best].argmax(-1).tolist())
    if args.save_history and process_index() == 0:
        h = res["history"]
        np.savez(args.save_history, rewards=h.rewards, latencies=h.latencies,
                 moved=h.moved, final_assignment=h.final_assignment,
                 finals=finals, rrs=rrs, start_epoch=res["start_epoch"])
    if args.serve:
        print(f"\nserving {args.serve} decision requests from the trained "
              f"policy across {len(finals)} cluster(s) ...")
        res["serve"] = serve_trained(res, args.serve, seed=args.seed)
        for kind, stats in res["serve"]["stats"].items():
            print(f"  {kind:13s} n={stats['n']:4d}  "
                  f"p50 {stats['p50_ms']:8.3f} ms  "
                  f"p99 {stats['p99_ms']:8.3f} ms")
    return res


if __name__ == "__main__":
    main()
