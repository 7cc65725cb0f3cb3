"""Paper Fig 12: robustness to a +50% workload change at mid-run —
actor-critic vs model-based on the three large-scale topologies.

Port of ``benchmarks/paper_fig12.py``.  The trained AC fleet re-schedules
online after the shift (:func:`run_shifted`): the shift is an EnvParams
edit (``scenarios.workload_shift``) against the same env spec.  The
model-based scheduler re-profiles the shifted system and re-runs its
search (:func:`refit_model_based`), as [25] would.

  python -m repro_torch.figures.fig12 [--paper-budget] [--apps ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import EpochDraws, make_agent, run_online_fleet
from repro_torch.core.model_based import ModelBasedScheduler
from repro_torch.dsdps import SchedulingEnv, scenarios
from repro_torch.figures.common import (Budget, make_env, run_actor_critic,
                                        run_model_based, seeded, timed)

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "paper"


def run_shifted(env: SchedulingEnv, cfg, states, budget: Budget, seed: int = 0,
                shift_factor: float = 1.5,
                draws: Sequence[EpochDraws] | None = None):
    """The trained DDPG fleet ``states`` (updated in place) online for
    ``max(T // 3, 40)`` epochs under the shifted workload (draws from a generator seeded with
    ``seed + 7`` unless passed in).  Returns (each lane's final assignment
    scored at the shifted rates, History)."""
    shifted = scenarios.workload_shift(env, shift_factor)
    with timed("shifted", env.device):
        states, hist = run_online_fleet(
            seed + 7, env, make_agent("ddpg", env, cfg=cfg), states,
            T=max(budget.online_epochs // 3, 40),
            updates_per_epoch=budget.updates_per_epoch, env_params=shifted,
            draws=draws)
        w_new = shifted.base_rates
        X = torch.as_tensor(hist.final_assignment, device=env.device)
        lats = [float(env.evaluate(X[f], w_new, params=shifted))
                for f in range(budget.n_seeds)]
    return lats, hist


def refit_model_based(env: SchedulingEnv, budget: Budget, seed: int = 0,
                      shift_factor: float = 1.5,
                      assignments: torch.Tensor | None = None,
                      meas_z: torch.Tensor | None = None) -> float:
    """[25] profiles the shifted system (an env built with the shifted
    workload; the fit's draws from a generator seeded with ``seed`` unless
    passed in) and searches again; its schedule scored at the shifted
    rates."""
    with timed("mb_refit", env.device):
        wl = dataclasses.replace(
            env.workload,
            base_rates=tuple(r * shift_factor for r in env.workload.base_rates))
        env_shift = SchedulingEnv(env.topo, wl, cluster=env.cluster,
                                  noise_sigma=env.noise_sigma, seed=env.seed,
                                  device=env.device)
        mb = ModelBasedScheduler(env_shift).fit(seeded(env, seed),
                                                n_samples=budget.mb_samples,
                                                assignments=assignments,
                                                meas_z=meas_z)
        w_new = scenarios.workload_shift(env, shift_factor).base_rates
        return float(env_shift.evaluate(mb.schedule(w_new, sweeps=3), w_new))


def run(app: str, budget: Budget, seed: int = 0, shift_factor: float = 1.5,
        device=None) -> dict:
    env = make_env(app, device)
    # pre-train the agent fleet on the unshifted workload
    ac_lats0, _, (states, cfg) = run_actor_critic(env, budget, seed)
    mb_lat0, _ = run_model_based(env, budget, seed)
    # shifted scenario: both methods adapt
    ac_after, _ = run_shifted(env, cfg, states, budget, seed, shift_factor)
    mb_after = refit_model_based(env, budget, seed, shift_factor)
    return {"app": app, "n_seeds": budget.n_seeds,
            "ac_before": float(np.mean(ac_lats0)),
            "ac_before_std": float(np.std(ac_lats0)),
            "mb_before": mb_lat0,
            "ac_after_shift": float(np.mean(ac_after)),
            "ac_after_shift_std": float(np.std(ac_after)),
            "ac_after_seeds": ac_after,
            "mb_after_shift": mb_after,
            "shift_factor": shift_factor}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper-budget", action="store_true")
    ap.add_argument("--apps", nargs="+",
                    default=["cq_large", "log_stream", "word_count"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    budget = Budget.paper() if args.paper_budget else Budget.quick()
    results = []
    for app in args.apps:
        out = run(app, budget, args.seed, device=args.device)
        results.append(out)
        print(f"[{app}] AC {out['ac_before']:.2f}±{out['ac_before_std']:.2f} "
              f"-> {out['ac_after_shift']:.2f}±{out['ac_after_shift_std']:.2f}ms "
              f"({out['n_seeds']} seeds), "
              f"model-based {out['mb_before']:.2f} -> {out['mb_after_shift']:.2f}ms "
              f"after +{(out['shift_factor'] - 1):.0%} workload "
              f"(paper Fig12 cq_large: AC 1.76 vs MB 2.17)", flush=True)
    ART.mkdir(parents=True, exist_ok=True)
    (ART / "fig12.json").write_text(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
