"""Fault tolerance end to end: train, checkpoint asynchronously, lose workers
(heartbeat detection), re-plan the mesh, resume from the newest checkpoint:
the 1000-node degradation path at demo scale.

Port of ``examples/elastic_restart.py``:

  python -m repro_torch.examples.elastic_restart [--device cpu]

The reference's printed lines and budget (the smoke llama3-8b, 10 steps
with an asynchronous save every 5, 16 of 512 workers lost, the multi-pod
re-plan, 5 steps after the restore) are kept, with one repair: the
reference reads its injected clock at 20.0, 15 s after the surviving
workers' last beats with a 10 s timeout, so it finds all 512 dead and its
``plan_mesh(0, ...)`` raises; the twin reads it at ``CHECK_AT`` = 12.0, 7 s
after those beats and 12 s after the silent workers' registration, and
loses the 16 the reference means to.  Where the reference restores into
the live state's structure, the twin restores into a fresh state drawn
from another seed, so the restore is what brings the trained weights
back."""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.checkpoint.checkpointer import AsyncCheckpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.fault.elastic import plan_mesh
from repro_torch.fault.heartbeat import HeartbeatMonitor
from repro_torch.train.trainer import TrainSetup, init_train_state, make_train_step

# the reference's numbers
STEPS, SAVE_EVERY, RESUMED_STEPS = 10, 5, 5
WORKERS, TIMEOUT_S, MODEL_PARALLEL = 512, 10.0, 16
BEAT_AT, CHECK_AT = 5.0, 12.0        # the reference checks at 20.0: all dead


def run(device: str | torch.device | None = None) -> dict:
    """The reference's example on ``device`` (default CUDA).  Prints its
    lines; returns the losses, the checkpointed steps, the dead workers,
    the re-plan and the step restored."""
    dev = resolve_device(device)
    cfg = get_config("llama3-8b", smoke=True)
    setup = TrainSetup(micro_batches=2, learning_rate=1e-3, warmup_steps=5,
                       total_steps=100)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)

    def batch(step: int) -> dict:
        return {k: v.to(dev) for k, v in batch_at(data, step).items()}

    losses = []
    with tempfile.TemporaryDirectory() as d:
        ckpt = AsyncCheckpointer(d, keep=2)
        state = init_train_state(cfg, setup,
                                 torch.Generator(device=dev).manual_seed(0), dev)
        step_fn = make_train_step(cfg, setup)

        print(f"training {STEPS} steps with async checkpoints every {SAVE_EVERY} ...")
        for step in range(STEPS):
            state, m = step_fn(state, batch(step))
            losses.append(float(m["loss"]))
            if (step + 1) % SAVE_EVERY == 0:
                ckpt.save_async(step + 1, state)
        ckpt.wait()
        steps = ckpt.all_steps()
        print(f"checkpoints on disk: {steps}, loss {losses[-1]:.3f}")

        # --- failure: 16 of 512 workers stop heartbeating -------------------
        t = [0.0]
        mon = HeartbeatMonitor(WORKERS, timeout_s=TIMEOUT_S, clock=lambda: t[0])
        t[0] = BEAT_AT
        for w in range(WORKERS):
            if w % 32 != 7:                      # host 7 of each pod row dies
                mon.beat(w)
        t[0] = CHECK_AT
        dead = mon.dead_workers()
        print(f"\nheartbeat monitor: {len(dead)} dead workers detected")

        plan = plan_mesh(WORKERS - len(dead), model_parallel=MODEL_PARALLEL,
                         multi_pod=True)
        print(f"elastic re-plan: {plan.shape} over {plan.axes} "
              f"({plan.device_count} devices)")

        # --- resume from the newest checkpoint, into a fresh state ----------
        fresh = init_train_state(cfg, setup,
                                 torch.Generator(device=dev).manual_seed(1), dev)
        state2 = ckpt.restore(fresh)
        resumed = int(state2.step)
        print(f"restored step {resumed}; continuing training ...")
        for step in range(resumed, resumed + RESUMED_STEPS):
            state2, m = step_fn(state2, batch(step))
            losses.append(float(m["loss"]))
        print(f"resumed cleanly; loss {losses[-1]:.3f}")
        ckpt.close()
    return dict(losses=losses, steps=steps, dead=sorted(dead), plan=plan,
                resumed=resumed)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
