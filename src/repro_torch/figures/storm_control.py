"""End-to-end driver — the paper's full control loop: offline training on
10k-scale random transitions, online learning on the large-scale topology,
comparison against default / model-based / DQN, and a +50% workload-shift
stress (Fig 12).

Port of ``examples/drl_storm_control.py``:

  python -m repro_torch.figures.storm_control [--app cq_large] [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.figures.common import Budget, compare_all
from repro_torch.figures.fig12 import run as run_shift


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="cq_large")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)

    budget = Budget.quick() if args.quick else Budget.paper()
    print(f"== scheduler comparison on {args.app} ==")
    compare_all(args.app, budget, device=args.device)
    print("\n== +50% workload shift (Fig 12) ==")
    shift = run_shift(args.app, budget, device=args.device)
    print(f"actor-critic after shift : {shift['ac_after_shift']:.2f} ms")
    print(f"model-based after shift  : {shift['mb_after_shift']:.2f} ms")


if __name__ == "__main__":
    main()
