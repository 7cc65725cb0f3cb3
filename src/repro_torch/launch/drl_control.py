"""The paper's control loop as a launcher: train a registry agent's fleet
on a DSDPS topology on the GPU and report the schedule.

Port of the DSDPS-app path of ``repro/launch/drl_control.py``: build the
env, initialize ``--fleet`` lanes of ``--agent`` (``ddpg``, ``dqn``,
``round_robin``, ``model_based``), each under its own scenario when
``--scenario`` names a heterogeneous fleet (``uniform``,
``one_slow_machine``, ``diurnal_rate``, ``high_noise``, ``mixed``; the
model-based baseline profiles and fits the lane's cluster), pretrain DDPG
lanes offline on random transitions, run ``--epochs`` online decision
epochs, and score every lane's final assignment against round-robin under
that lane's scenario.

  PYTHONPATH=src python -m repro_torch.launch.drl_control --app cq_large \\
      --fleet 8 --offline 2000 --epochs 300
  PYTHONPATH=src python -m repro_torch.launch.drl_control --app cq_large \\
      --agent model_based --scenario one_slow_machine --fleet 8
  PYTHONPATH=src python -m repro_torch.launch.drl_control --device cpu \\
      --app cq_small --fleet 2 --offline 50 --offline-updates 5 --epochs 5

Runs on CUDA unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import agent_names, make_agent, run_online_fleet
from repro_torch.core import ddpg as ddpg_lib
from repro_torch.device import resolve_device
from repro_torch.dsdps import SchedulingEnv, apps, scenarios
from repro_torch.dsdps.apps import default_workload


def build_env(app: str, device) -> SchedulingEnv:
    topo = apps.ALL_APPS[app]()
    return SchedulingEnv(topo, default_workload(topo), device=device)


def run(app: str = "cq_small", agent: str = "ddpg", fleet: int = 4,
        offline: int = 2000, offline_updates: int = 500, epochs: int = 300,
        k: int = 12, seed: int = 0,
        device: str | torch.device | None = None,
        scenario: str | None = None,
        broadcast_invariant: bool = False) -> dict:
    """Run the loop; returns a dict with the env, the scenario fleet (None
    without ``scenario``), the agent, the trained states, the History,
    per-lane final and round-robin latencies (ms, each under the lane's
    scenario), the index of the best lane (lowest final/round-robin), the
    wall seconds of each phase (``init`` holds the model-based fit) and
    the online lane-epochs/s.  ``k`` sizes DDPG's K-NN beam and
    ``offline`` pretrains DDPG lanes; the other agents ignore both."""
    dev = resolve_device(device)

    def now() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    seconds = {}
    t0 = now()
    env = build_env(app, dev)
    env_params = (scenarios.build(scenario, env, fleet,
                                  broadcast_invariant=broadcast_invariant)
                  if scenario else None)
    ag = make_agent(agent, env, **({"k_nn": k} if agent == "ddpg" else {}))
    # lanes initialize under their own scenario: the model-based baseline
    # profiles and fits the lane's cluster, not the nominal one
    states = ag.init_fleet(torch.Generator(device=dev).manual_seed(seed),
                           fleet, dev, env_params=env_params)
    t1 = now()
    seconds["init"] = t1 - t0
    if agent == "ddpg" and offline > 0:
        states = ddpg_lib.offline_pretrain(
            states, ag.cfg, env, n_samples=offline, n_updates=offline_updates,
            env_params=env_params,
            gen=torch.Generator(device=dev).manual_seed(seed + 1))
    t2 = now()
    seconds["offline"] = t2 - t1
    states, hist = run_online_fleet(
        torch.Generator(device=dev).manual_seed(seed + 2), env, ag, states,
        T=epochs, env_params=env_params)
    t3 = now()
    seconds["online"] = t3 - t2

    # score every lane under the scenario it ran, noise-free, round-robin
    # too, so the improvement compares like with like per lane
    p = env.default_params() if env_params is None else env_params
    w = p.base_rates.expand(fleet, -1)
    X = torch.as_tensor(hist.final_assignment, device=dev)
    X_rr = env.round_robin_assignment().expand(fleet, env.N, env.M)
    finals = env.evaluate(X, w, params=p).cpu().numpy().astype(np.float64)
    rrs = env.evaluate(X_rr, w, params=p).cpu().numpy().astype(np.float64)
    seconds["score"] = now() - t3
    best = int((finals / rrs).argmin())
    return dict(env=env, env_params=env_params, agent=ag, states=states,
                history=hist, finals=finals, rrs=rrs, best=best,
                seconds=seconds,
                lane_epochs_per_s=fleet * epochs / seconds["online"])


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", default="cq_small", choices=list(apps.ALL_APPS))
    ap.add_argument("--agent", default="ddpg", choices=list(agent_names()),
                    help="registered control policy (core.api.make_agent)")
    ap.add_argument("--scenario", default=None,
                    choices=sorted(scenarios.SCENARIOS),
                    help="heterogeneous params fleet, one scenario per lane, "
                         "instead of a pure seed sweep")
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
    args = ap.parse_args(argv)
    if args.fleet < 1:
        ap.error("--fleet must be >= 1")
    scen = f" ({args.scenario} scenario fleet)" if args.scenario else ""
    pre = (f"{args.offline} offline samples, {args.offline_updates} offline "
           f"updates, " if args.agent == "ddpg" else "")
    print(f"{args.agent} fleet of {args.fleet} on {args.app}{scen}: "
          f"{pre}{args.epochs} online epochs ...")
    res = run(app=args.app, agent=args.agent, fleet=args.fleet,
              offline=args.offline, offline_updates=args.offline_updates,
              epochs=args.epochs, k=args.k, seed=args.seed, device=args.device,
              scenario=args.scenario,
              broadcast_invariant=args.broadcast_invariant)
    finals, rrs, best = res["finals"], res["rrs"], res["best"]
    print(f"\nfinal latency {finals.mean():.3f} ± {finals.std():.3f} ms "
          f"over {args.fleet} lanes "
          f"(best lane {best}: {finals[best]:.3f} ms)   "
          f"round-robin {rrs.mean():.3f} ms   "
          f"improvement {1 - finals.mean() / rrs.mean():.1%} mean / "
          f"{1 - finals[best] / rrs[best]:.1%} best")
    print("best assignment (executor -> machine):",
          res["history"].final_assignment[best].argmax(-1).tolist())
    return res


if __name__ == "__main__":
    main()
