"""Paper Figs 7/9/11: normalized + smoothed reward over online learning
for actor-critic vs DQN (large-scale topologies), seed-averaged over the
fleet (mean curve ± std band across budget.n_seeds independent runs).

Port of ``benchmarks/paper_reward.py``:

  python -m repro_torch.figures.reward --app cq_large [--epochs 400] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib

import numpy as np

from repro_torch.figures.common import Budget, make_env, run_actor_critic, run_dqn

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "paper"


def run(app: str, budget: Budget, seed: int = 0, device=None) -> dict:
    env = make_env(app, device)
    _, dqn_hist = run_dqn(env, budget, seed, deploy=False)
    _, ac_hist, _ = run_actor_critic(env, budget, seed, deploy=False)
    dqn_mean, dqn_std = dqn_hist.seed_band()
    ac_mean, ac_std = ac_hist.seed_band()
    out = {
        "app": app,
        "epochs": budget.online_epochs,
        "n_seeds": budget.n_seeds,
        "dqn_smoothed_mean": dqn_mean.tolist(),
        "dqn_smoothed_std": dqn_std.tolist(),
        "ac_smoothed_mean": ac_mean.tolist(),
        "ac_smoothed_std": ac_std.tolist(),
    }
    last = max(len(ac_mean) // 5, 1)
    out["ac_final_avg"] = float(np.mean(ac_mean[-last:]))
    out["dqn_final_avg"] = float(np.mean(dqn_mean[-last:]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="cq_large")
    ap.add_argument("--epochs", type=int, default=0)
    ap.add_argument("--paper-budget", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    budget = Budget.paper() if args.paper_budget else Budget.quick()
    if args.epochs:
        budget = dataclasses.replace(budget, online_epochs=args.epochs)
    out = run(args.app, budget, args.seed, args.device)
    ART.mkdir(parents=True, exist_ok=True)
    (ART / f"reward_{args.app}.json").write_text(json.dumps(out))
    print(f"[{args.app}] final smoothed reward: "
          f"actor-critic {out['ac_final_avg']:.3f} vs "
          f"DQN {out['dqn_final_avg']:.3f} "
          f"(paper Fig 7: AC climbs above DQN's ~0.44)")


if __name__ == "__main__":
    main()
