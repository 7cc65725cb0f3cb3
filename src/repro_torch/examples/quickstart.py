"""Quickstart: model-free DRL scheduling of a Storm topology.

Port of ``examples/quickstart.py``.  Trains the paper's actor-critic agent
(Algorithm 1) on the small continuous-queries topology and compares the
learned schedule against Storm's default round-robin scheduler.

  python -m repro_torch.examples.quickstart [--device cpu]

The reference's key offsets become generator seeds: ``SEED`` for the
initial state, ``SEED + 1`` for offline pretraining, ``SEED + 2`` for the
online run."""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import make_agent, run_online_agent
from repro_torch.core.ddpg import offline_pretrain
from repro_torch.core.exploration import EpsilonSchedule
from repro_torch.dsdps import SchedulingEnv, apps
from repro_torch.dsdps.apps import default_workload


# the reference's numbers
K_NN, EPS_DECAY, UPDATES_PER_EPOCH, SEED = 8, 120, 2, 0
OFFLINE_SAMPLES, OFFLINE_UPDATES, EPOCHS = 800, 300, 180


def run(offline_samples: int = OFFLINE_SAMPLES,
        offline_updates: int = OFFLINE_UPDATES, epochs: int = EPOCHS,
        device: str | torch.device | None = None) -> dict:
    """The reference's quickstart at its budget (the defaults), on
    ``device`` (default CUDA).  Prints its lines; returns the Storm-default
    and learned latencies, the improvement and the run's History."""
    topo = apps.continuous_queries("small")
    print(topo.describe(), "\n")
    env = SchedulingEnv(topo, default_workload(topo), device=device)
    seeded = lambda s: torch.Generator(device=env.device).manual_seed(s)  # noqa: E731

    # any registered policy plugs into the same control loop:
    # "ddpg" (Algorithm 1), "dqn", "round_robin", "model_based"
    agent = make_agent("ddpg", env, k_nn=K_NN,
                       eps=EpsilonSchedule(decay_epochs=EPS_DECAY))
    state = agent.init_fleet(seeded(SEED), 1, env.device)

    print("offline pretraining on random-action transitions ...")
    state = offline_pretrain(state, agent.cfg, env, n_samples=offline_samples,
                             n_updates=offline_updates, gen=seeded(SEED + 1))

    print(f"online learning ({epochs} decision epochs) ...")
    state, hist = run_online_agent(SEED + 2, env, agent, state, T=epochs,
                                   updates_per_epoch=UPDATES_PER_EPOCH)

    w = env.default_params().base_rates
    Xd, mask, nproc = env.storm_default_assignment()
    default = float(env.evaluate(Xd, w, same_proc=mask, n_procs=nproc))
    learned = float(env.evaluate(
        torch.as_tensor(hist.final_assignment, device=env.device), w))
    print(f"\nStorm default scheduler : {default:.2f} ms avg tuple time")
    print(f"DRL-learned schedule    : {learned:.2f} ms avg tuple time")
    print(f"improvement             : {1 - learned / default:.1%}")
    print("\nexecutor -> machine:",
          hist.final_assignment.argmax(-1).tolist())
    return dict(default=default, learned=learned,
                improvement=1 - learned / default, history=hist)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
