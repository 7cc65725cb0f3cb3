"""Paper Fig 6: average tuple processing time on the continuous-queries
topology, small/medium/large, × {default, model-based, DQN, actor-critic}.

Port of ``benchmarks/paper_fig6.py``.  DRL entries are mean ± std over a
fleet of budget.n_seeds independent seeds (one batched run), and
fig6.json includes the seed-averaged online reward curves with variance
bands (``{dqn,ac}_curve_mean/std``).

  python -m repro_torch.figures.fig6 [--paper-budget] [--seed N] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.figures.common import Budget, compare_all

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "paper"
APPS = ("cq_small", "cq_medium", "cq_large")


def run(budget: Budget, seed: int = 0, device=None) -> list[dict]:
    results = []
    for app in APPS:
        out = compare_all(app, budget, seed, device=device)
        out.pop("_dqn_hist"), out.pop("_ac_hist")
        results.append(out)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper-budget", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    budget = Budget.paper() if args.paper_budget else Budget.quick()
    results = run(budget, args.seed, args.device)
    ART.mkdir(parents=True, exist_ok=True)
    (ART / "fig6.json").write_text(json.dumps(results, indent=2))
    print("\npaper Fig6 reference (default / model / dqn / AC, ms):")
    print("  small  1.96 / 1.46 / 1.54 / 1.33   (paper)")
    print("  medium 2.08 / 1.61 / 1.59 / 1.43   (paper)")
    print("  large  2.64 / 2.12 / 2.45 / 1.72   (paper)")


if __name__ == "__main__":
    main()
