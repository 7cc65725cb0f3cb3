"""Train a ~100M-parameter llama-family model for a few hundred steps on
the deterministic synthetic pipeline, with asynchronous checkpoints and a
mid-run restart that is checked to resume exactly.

Port of ``examples/train_lm.py``:

  python -m repro_torch.examples.train_lm [--steps 300] [--tiny] [--device cpu]

The reference's printed lines are kept as they are; between the two runs
the twin also restores the checkpoint the restart will read into a fresh
state and checks that every leaf equals the one saved, bit for bit."""
from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, named_leaves
from repro_torch.device import resolve_device
from repro_torch.launch.train import run_training
from repro_torch.models.config import ModelConfig
from repro_torch.train.trainer import TrainSetup, init_train_state

# the reference's numbers
STEPS, BATCH, SEQ, MICRO, LR, WARMUP = 300, 8, 256, 2, 3e-4, 20


def hundred_m_config(tiny: bool) -> ModelConfig:
    if tiny:    # CI-scale variant (~2M params)
        return ModelConfig(name="demo-2m", family="dense", num_layers=2,
                           d_model=128, num_heads=4, num_kv_heads=2,
                           d_ff=256, vocab_size=2048)
    return ModelConfig(                 # ~100M params
        name="demo-100m", family="dense",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
        d_ff=2048, vocab_size=32768,
    )


def restored_equal(ckpt_dir: str, cfg: ModelConfig, setup: TrainSetup, saved,
                   device) -> int:
    """Restore the newest step of ``ckpt_dir`` into a fresh state and hold
    every leaf to ``saved``'s bit for bit; returns the number of leaves."""
    fresh = init_train_state(cfg, setup, torch.Generator(device=device).manual_seed(1),
                             device)
    restored = Checkpointer(ckpt_dir).restore(fresh)
    pairs = list(zip(named_leaves(restored), named_leaves(saved)))
    for (name, got), (_, want) in pairs:
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"restored leaf {name} differs from the saved one")
    return len(pairs)


def run(steps: int = STEPS, batch: int = BATCH, seq: int = SEQ, tiny: bool = False,
        device: str | torch.device | None = None) -> dict:
    """The reference's example (its budget by default) on ``device``
    (default CUDA).  Prints its lines; returns both runs' results and the
    number of leaves restored bit for bit."""
    dev = resolve_device(device)
    cfg = hundred_m_config(tiny)
    setup = TrainSetup(micro_batches=MICRO, learning_rate=LR,
                       warmup_steps=WARMUP, total_steps=steps)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        half = steps // 2
        print(f"training {cfg.name} ({cfg.param_count() / 1e6:.0f}M params) "
              f"for {half} steps, then restarting from checkpoint ...")
        out1 = run_training(cfg, setup, half, batch, seq,
                            ckpt_dir=ckpt_dir, ckpt_every=max(half // 2, 1),
                            log_every=10, device=dev)
        n_leaves = restored_equal(ckpt_dir, cfg, setup, out1["state"], dev)
        print("\n-- simulated preemption: restarting from checkpoint --\n")
        out2 = run_training(cfg, setup, steps, batch, seq,
                            ckpt_dir=ckpt_dir, ckpt_every=50, resume=True,
                            log_every=10, device=dev)
        print(f"\nloss {out1['losses'][0]:.3f} -> {out2['losses'][-1]:.3f} "
              f"over {steps} steps (resumed mid-run)")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"first": out1, "second": out2, "restored_leaves": n_leaves}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    return run(steps=args.steps, batch=args.batch, seq=args.seq, tiny=args.tiny,
               device=args.device)


if __name__ == "__main__":
    main()
