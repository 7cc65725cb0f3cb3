"""Serving control-plane launcher: batched decisions for many clusters.

Port of ``repro/launch/serve_control.py``.  Builds a
:class:`~repro_torch.serve.control.ControlService` over the requested
decision kinds (``core/spaces.py`` action spaces — placement is served by
a fresh or supplied DDPG agent, rate_control / auto_tune by their
registered policy agents), registers ``--clusters`` perturbed live
clusters (``dsdps.scenarios.sample_perturbed``), drives a synthetic
request load through it, and reports per-kind p50/p99 decision latency
and decisions/sec.  The clusters' draws and the agents' weights come from
CPU generators seeded with ``--seed``, so every device serves the same
policies for the same clusters.

  PYTHONPATH=src python -m repro_torch.launch.serve_control --app cq_large \\
      --clusters 16 --requests 256 --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve_control --device cpu \\
      --kinds placement,rate_control --clusters 3 --requests 24
  PYTHONPATH=src python -m repro_torch.launch.serve_control --app cq_large \\
      --clusters 6 --requests 48 --slots 8 --guards

Runs on CUDA unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.  ``--guards`` serves the steady state (every
step after the warm-up) under ``diagnostics.guards(transfer="log")`` and
prints the synchronizing calls per plane step with their sites; the
reference's guard asserts that no plane recompiles, and no plane of the
port compiles.  ``drl_control --serve N`` reuses
:func:`build_service` / :func:`synthetic_requests` to serve N decisions
from the freshly trained policy, each training lane's scenario registered
as a cluster."""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.core import convert, make_agent, spaces
from repro_torch.device import resolve_device
from repro_torch.diagnostics import guards as guard_region
from repro_torch.dsdps import SchedulingEnv, apps, scenarios
from repro_torch.dsdps.apps import default_workload
from repro_torch.serve.control import (ControlPlane, ControlService,
                                       DecisionRequest)

DEFAULT_KINDS = ("placement", "rate_control", "auto_tune")


def init_one(agent, seed: int, device):
    """A one-lane state of ``agent`` made on the CPU from a generator
    seeded with ``seed`` and carried to ``device``: the same weights on any
    device."""
    st = agent.init_fleet(torch.Generator().manual_seed(seed), 1, "cpu")
    if isinstance(st, torch.Tensor):
        return st.to(device)
    return convert.ddpg_state_from_numpy(convert.ddpg_state_to_numpy(st),
                                         device)


def build_service(env, kinds=DEFAULT_KINDS, n_slots: int = 8, seed: int = 0,
                  placement_agent=None,
                  placement_state=None) -> ControlService:
    """One plane per decision kind; each kind's registered default agent
    (:func:`init_one`), except ``placement`` which may be served by a
    supplied (trained) agent + one-lane state."""
    planes = {}
    for kind in kinds:
        space = spaces.action_space(kind)
        if kind == "placement" and placement_agent is not None:
            ag, st = placement_agent, placement_state
        else:
            overrides = {"k_nn": 8} if space.default_agent == "ddpg" else {}
            ag = make_agent(space.default_agent, env, **overrides)
            st = init_one(ag, seed, env.device)
        planes[kind] = ControlPlane(env, ag, st, kind=kind, n_slots=n_slots,
                                    explore=False)
    return ControlService(planes)


def synthetic_requests(env, svc: ControlService, n_requests: int,
                       seed: int = 0) -> list[DecisionRequest]:
    """A request mix round-robining over the service's clusters and
    kinds: random feasible assignments + lognormal-jittered spout loads,
    encoded exactly as ``SchedulingEnv.state_vector`` would (the
    reference's numpy draws, so both packages serve the same requests)."""
    rng = np.random.default_rng(seed)
    kinds = svc.kinds
    names = svc.planes[kinds[0]].clusters
    reqs = []
    for rid in range(n_requests):
        X = np.eye(env.M, dtype=np.float32)[rng.integers(0, env.M, env.N)]
        w_norm = np.exp(rng.normal(0.0, 0.25, env.workload.num_spouts))
        s_vec = np.concatenate([X.reshape(-1),
                                w_norm.astype(np.float32)])
        reqs.append(DecisionRequest(rid=rid,
                                    cluster=names[rid % len(names)],
                                    s_vec=s_vec,
                                    kind=kinds[rid % len(kinds)]))
    return reqs


def serve(svc: ControlService, reqs: list[DecisionRequest],
          guards: bool = False) -> dict:
    """Submit ``reqs``, take one warm-up step (each plane's first select),
    then drain the rest.  Returns the served requests, the warm-up's, the
    wall seconds after warm-up, the decisions/s over them and the
    per-kind latency stats (warm-up included, as the reference reports).
    With ``guards`` the drain runs under ``guards(transfer="log")``, and
    ``guards`` holds its ``GuardState``, ``steady_steps`` the plane steps
    taken (else None)."""
    for r in reqs:
        svc.submit(r)
    warm = svc.step()
    devices = {p.device for p in svc.planes.values()}

    def now() -> float:
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return time.perf_counter()

    def plane_steps() -> int:
        return sum(p.steps for p in svc.planes.values())

    region = (guard_region(transfer="log", label="serve_control") if guards
              else contextlib.nullcontext())
    before = plane_steps()
    t0 = now()
    with region as g:
        served = svc.run()
    wall = now() - t0
    if g is not None:
        g.steady_steps = plane_steps() - before
    steady = len(served) - len(warm)
    return dict(served=served, warm=warm, wall_s=wall,
                decisions_per_s=steady / wall if wall > 0 else float("inf"),
                stats=svc.decision_stats(), guards=g)


def register_perturbed(svc: ControlService, env, n_clusters: int,
                       seed: int = 0) -> None:
    """Register ``cluster-0`` … with ``sample_perturbed`` scenarios, the
    draws from one CPU generator seeded with ``seed`` (the same clusters on
    any device)."""
    gen = torch.Generator().manual_seed(seed)
    for c in range(n_clusters):
        svc.register_cluster(f"cluster-{c}",
                             scenarios.sample_perturbed(env, gen=gen))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", default="cq_small", choices=list(apps.ALL_APPS))
    ap.add_argument("--kinds", default=",".join(DEFAULT_KINDS),
                    help="comma-separated decision kinds "
                         f"(registered: {spaces.action_space_names()})")
    ap.add_argument("--clusters", type=int, default=4,
                    help="live clusters to register (perturbed scenarios)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4,
                    help="batch slots per decision plane")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--guards", action="store_true",
                    help="serve the steady state under the runtime guards "
                         "(repro_torch.diagnostics, transfer='log') and "
                         "print the synchronizing calls per plane step")
    args = ap.parse_args(argv)
    kinds = tuple(k for k in args.kinds.split(",") if k)
    for k in kinds:
        if k not in spaces.action_space_names():
            ap.error(f"unknown decision kind {k!r}; "
                     f"registered: {spaces.action_space_names()}")
    if args.clusters < 1 or args.requests < 1:
        ap.error("--clusters and --requests must be >= 1")

    dev = resolve_device(args.device)
    topo = apps.ALL_APPS[args.app]()
    env = SchedulingEnv(topo, default_workload(topo), device=dev)
    svc = build_service(env, kinds, n_slots=args.slots, seed=args.seed)
    register_perturbed(svc, env, args.clusters, seed=args.seed)
    print(f"serving {len(kinds)} decision kind(s) {list(kinds)} for "
          f"{args.clusters} clusters, {args.slots} slots/plane on {dev} ...")
    res = serve(svc, synthetic_requests(env, svc, args.requests,
                                        seed=args.seed), guards=args.guards)
    steady = len(res["served"]) - len(res["warm"])
    print(f"served {len(res['served'])}/{args.requests} decisions "
          f"({steady} post-warmup in {res['wall_s'] * 1e3:.1f} ms = "
          f"{res['decisions_per_s']:.0f} decisions/sec)")
    for kind, stats in res["stats"].items():
        print(f"  {kind:13s} n={stats['n']:4d}  "
              f"p50 {stats['p50_ms']:8.3f} ms  "
              f"p99 {stats['p99_ms']:8.3f} ms  "
              f"mean {stats['mean_ms']:8.3f} ms")
    if res["guards"] is not None:
        print(f"guards: {res['guards'].sync_report(per='plane step')}")
    return dict(res, env=env, service=svc)


if __name__ == "__main__":
    main()
