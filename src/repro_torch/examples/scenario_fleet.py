"""Scenario fleets: heterogeneous operating regimes in one fleet.

Port of ``examples/scenario_fleet.py``.  A fleet of online-learning runs
can differ not just by seed but by SCENARIO — per-lane workload rates,
service-time jitter, telemetry noise and straggler machines — while every
lane steps in the same batched loop.  This script trains an actor-critic
fleet over the "mixed" scenario distribution and reports per-lane results,
then re-runs the trained fleet under a +50% global rate shift (a parameter
edit).

  python -m repro_torch.examples.scenario_fleet [--fleet 8] [--epochs 150] [--device cpu]

The reference's ``PRNGKey(0)`` (initial states) and ``PRNGKey(1)`` (the
lanes' run keys, both runs) become generator seeds ``SEED`` and
``SEED + 1``.  The reference's printed lines are kept as they are."""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import make_agent, run_online_fleet
from repro_torch.dsdps import (SchedulingEnv, apps, lane_params, scale_rates,
                               scenarios)
from repro_torch.dsdps.apps import default_workload


def _synced(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the reference's numbers
K_NN, SEED = 8, 0
FLEET, EPOCHS, SCENARIO = 8, 150, "mixed"


def run(fleet: int = FLEET, epochs: int = EPOCHS, scenario: str = SCENARIO,
        broadcast_invariant: bool = False,
        device: str | torch.device | None = None) -> dict:
    """The reference's scenario fleet at its budget (the defaults), then the
    re-run with every base rate 1.5 × higher, on ``device`` (default CUDA).
    Prints its lines; returns both Histories, each lane's final latency
    and the wall seconds of both runs."""
    topo = apps.continuous_queries("small")
    env = SchedulingEnv(topo, default_workload(topo), device=device)
    agent = make_agent("ddpg", env, k_nn=K_NN)

    params = scenarios.build(scenario, env, fleet,
                             broadcast_invariant=broadcast_invariant)
    states = agent.init_fleet(torch.Generator(device=env.device).manual_seed(SEED),
                              fleet, env.device, env_params=params)

    print(f"training {fleet} heterogeneous '{scenario}' lanes x "
          f"{epochs} epochs as one program ...")
    t0 = time.perf_counter()
    states, hist = run_online_fleet(SEED + 1, env, agent, states, T=epochs,
                                    env_params=params)
    _synced(env.device)
    dt = time.perf_counter() - t0
    print(f"  {fleet * epochs} lane-epochs in {dt:.1f}s "
          f"(incl. compile)\n")
    print("lane  mean-latency(ms)  final-latency(ms)")
    finals = []
    for f in range(fleet):
        lane_p = lane_params(params, env.default_params(), f)
        final = float(env.evaluate(
            torch.as_tensor(hist.final_assignment[f], device=env.device),
            lane_p.base_rates, params=lane_p))
        finals.append(final)
        print(f"  {f:2d}  {hist.latencies[f].mean():16.3f}  {final:17.3f}")

    # a workload shift is just a parameter edit of the same fleet
    shifted = scale_rates(params, 1.5)
    t0 = time.perf_counter()
    _, hist2 = run_online_fleet(SEED + 1, env, agent, states, T=epochs,
                                env_params=shifted)
    _synced(env.device)
    dt2 = time.perf_counter() - t0
    print(f"\n+50% rate shift re-run: {dt2:.1f}s (no recompilation) — "
          f"mean latency {hist.latencies.mean():.2f} -> "
          f"{hist2.latencies.mean():.2f} ms")
    return dict(history=hist, shifted=hist2, finals=finals,
                seconds=dict(train=dt, shifted=dt2))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=FLEET)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--scenario", default=SCENARIO,
                    choices=list(scenarios.SCENARIOS))
    ap.add_argument("--broadcast-invariant", action="store_true",
                    help="keep scenario-invariant params fields single-copy "
                         "(broadcast over the lanes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    return run(fleet=args.fleet, epochs=args.epochs, scenario=args.scenario,
               broadcast_invariant=args.broadcast_invariant, device=args.device)


if __name__ == "__main__":
    main()
