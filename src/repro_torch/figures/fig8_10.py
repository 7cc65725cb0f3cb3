"""Paper Figs 8 & 10: log-stream-processing and word-count (large-scale),
× the four schedulers.  DRL entries are mean ± std over a seed fleet (one
batched run); fig8_10.json carries the seed-averaged reward curves.

Port of ``benchmarks/paper_fig8_10.py``:

  python -m repro_torch.figures.fig8_10 [--paper-budget] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.figures.common import Budget, compare_all

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "paper"
APPS = ("log_stream", "word_count")


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
    (ART / "fig8_10.json").write_text(json.dumps(results, indent=2))
    print("\npaper reference (default / model / dqn / AC, ms):")
    print("  log stream 9.61 / 7.91 / 8.19 / 7.20   (paper Fig 8)")
    print("  word count 3.10 / 2.16 / 2.29 / 1.70   (paper Fig 10)")


if __name__ == "__main__":
    main()
