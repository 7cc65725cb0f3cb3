"""The paper's control loop as a launcher: train a DDPG fleet on a DSDPS
topology on the GPU and report the schedule.

Port of the DSDPS-app, DDPG path of ``repro/launch/drl_control.py``:
build the env, initialize ``--fleet`` lanes, pretrain each offline on
random transitions, run ``--epochs`` online decision epochs, and score
every lane's final assignment against round-robin.

  PYTHONPATH=src python -m repro_torch.launch.drl_control --app cq_large \\
      --fleet 8 --offline 2000 --epochs 300
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
from repro_torch.dsdps import SchedulingEnv, apps
from repro_torch.dsdps.apps import default_workload


def build_env(app: str, device) -> SchedulingEnv:
    topo = apps.ALL_APPS[app]()
    return SchedulingEnv(topo, default_workload(topo), device=device)


def run(app: str = "cq_small", agent: str = "ddpg", fleet: int = 4,
        offline: int = 2000, offline_updates: int = 500, epochs: int = 300,
        k: int = 12, seed: int = 0,
        device: str | torch.device | None = None) -> dict:
    """Run the loop; returns a dict with the env, the trained states, the
    History, per-lane final and round-robin latencies (ms), the index of
    the best lane, and the wall seconds of each phase."""
    dev = resolve_device(device)

    def now() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    seconds = {}
    t0 = now()
    env = build_env(app, dev)
    ag = make_agent(agent, env, k_nn=k)
    states = ag.init_fleet(torch.Generator(device=dev).manual_seed(seed),
                           fleet, dev)
    t1 = now()
    seconds["init"] = t1 - t0
    if offline > 0:
        states = ddpg_lib.offline_pretrain(
            states, ag.cfg, env, n_samples=offline, n_updates=offline_updates,
            gen=torch.Generator(device=dev).manual_seed(seed + 1))
    t2 = now()
    seconds["offline"] = t2 - t1
    states, hist = run_online_fleet(
        torch.Generator(device=dev).manual_seed(seed + 2), env, ag, states,
        T=epochs)
    t3 = now()
    seconds["online"] = t3 - t2

    # score every lane's final assignment against round-robin, noise-free
    w = env.default_params().base_rates
    X = torch.as_tensor(hist.final_assignment, device=dev)
    finals = env.evaluate(X, w).cpu().numpy().astype(np.float64)
    rr = float(env.evaluate(env.round_robin_assignment(), w))
    rrs = np.full(fleet, rr)
    seconds["score"] = now() - t3
    best = int((finals / rrs).argmin())
    return dict(env=env, states=states, history=hist, finals=finals, rrs=rrs,
                best=best, seconds=seconds,
                lane_epochs_per_s=fleet * epochs / seconds["online"])


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", default="cq_small", choices=list(apps.ALL_APPS))
    ap.add_argument("--agent", default="ddpg", choices=list(agent_names()))
    ap.add_argument("--offline", type=int, default=2000,
                    help="offline random-action samples per lane "
                         "(paper: 10,000)")
    ap.add_argument("--offline-updates", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--fleet", type=int, default=4,
                    help="independent online-learning lanes, batched")
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    if args.fleet < 1:
        ap.error("--fleet must be >= 1")
    print(f"{args.agent} fleet of {args.fleet} on {args.app}: "
          f"{args.offline} offline samples, {args.offline_updates} offline "
          f"updates, {args.epochs} online epochs ...")
    res = run(app=args.app, agent=args.agent, fleet=args.fleet,
              offline=args.offline, offline_updates=args.offline_updates,
              epochs=args.epochs, k=args.k, seed=args.seed, device=args.device)
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
