"""End-to-end LM training launcher (``repro/launch/train.py``).

Binds: config → seeded init → the deterministic data pipeline → the
microbatched train step → asynchronous checkpoints → heartbeat and
straggler monitoring.  It runs on the card unless ``--device cpu`` is
given.  With ``--mesh production`` the same path runs over
``launch.mesh.make_production_mesh`` with the sharding policy applied
(``trainer.shard_train_state``): one process a card, joined through
``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``
(NCCL on the card, gloo on the CPU; without them a world of one).  Every
rank reads the same global batch and trains on its rows; rank 0 prints and
writes the checkpoints, gathered into the unmeshed layout, so a run
resumes in any world size.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
      --steps 20 --batch 8 --seq 128 [--device cpu] [--mesh production]

A vlm's patch embeddings and an encdec's frames, which the reference draws
with ``jax.random`` a step, come from a ``torch.Generator`` seeded with the
step, or from ``frames_fn`` (ROADMAP C4)."""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import AsyncCheckpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, PrefetchIterator
from repro_torch.device import resolve_device
from repro_torch.fault.heartbeat import HeartbeatMonitor
from repro_torch.fault.straggler import StragglerDetector
from repro_torch.launch.mesh import (init_distributed, lm_backend, make_production_mesh,
                                     process_count, process_index)
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.policy import ShardingPolicy
from repro_torch.train.trainer import (DTYPES, TrainSetup, cached_train_step,
                                       init_train_state, shard_train_state,
                                       unshard_train_state)

SEED = 0                 # the parameters' draw, as the reference's PRNGKey(0)


def frontend_inputs(cfg: ModelConfig, step: int, batch: int, seq_len: int,
                    device: torch.device) -> dict:
    """A step's inputs beside its tokens, from a generator seeded with the
    step, at the token embeddings' scale (0.02), in the config's dtype: a
    vlm's ``frontend_embeds`` ``[batch, frontend_positions, d]``, an
    encdec's ``frames`` ``[batch, seq_len, d]``; nothing for the other
    families."""
    if cfg.family == "vlm":
        shape, name = (batch, cfg.frontend_positions, cfg.d_model), "frontend_embeds"
    elif cfg.family == "encdec":
        shape, name = (batch, seq_len, cfg.d_model), "frames"
    else:
        return {}
    gen = torch.Generator(device=device).manual_seed(step)
    draw = torch.randn(shape, generator=gen, device=device).mul_(0.02)
    return {name: draw.to(DTYPES[cfg.dtype])}


def step_times(dt: float, world: int) -> list[float]:
    """Every rank's wall time of the step, on every rank (one all-gather
    over the process group; ``[dt]`` alone in one process)."""
    if world == 1:
        return [dt]
    every: list = [None] * world
    dist.all_gather_object(every, dt)
    return every


def run_training(cfg: ModelConfig, setup: TrainSetup, steps: int, global_batch: int,
                 seq_len: int, ckpt_dir: str | None = None, ckpt_every: int = 50,
                 resume: bool = True, log_every: int = 1, mesh=None, frames_fn=None,
                 device: str | torch.device | None = None) -> dict:
    """Train steps ``[start, steps)`` on the pipeline's batches, the start
    0 or, with ``resume`` and a checkpoint in ``ckpt_dir``, its newest
    step; save every ``ckpt_every`` steps.  ``frames_fn(step, batch)``
    gives a step's frontend inputs (default ``frontend_inputs``).  Returns
    {"losses" (the steps run), "state", "total_s", "start_step"}.

    With ``mesh`` (a ``DeviceMesh`` over the process group, every rank
    calling this alike) the state is sharded by the policy and the step
    runs over the mesh; the returned state is the sharded one.  A
    checkpoint is gathered whole and written by rank 0 in the unmeshed
    layout, and every rank restores the newest one before sharding it, so
    a run resumes at any world size.  The heartbeat and straggler monitors
    watch every rank's step time; only rank 0 prints."""
    dev = resolve_device(device)
    rank, world = process_index(), process_count()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=global_batch)
    if frames_fn is None:
        frames_fn = lambda step, b: frontend_inputs(cfg, step, b, seq_len, dev)  # noqa: E731

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    state = init_train_state(cfg, setup, torch.Generator(device=dev).manual_seed(SEED), dev)
    if ckpt and resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = int(state.step)
        if rank == 0:
            print(f"resumed from step {start_step}")
    if mesh is not None:
        state = shard_train_state(state, ShardingPolicy(mesh, cfg))

    train_step = cached_train_step(cfg, setup, mesh)
    monitor = HeartbeatMonitor(num_workers=world)
    stragglers = StragglerDetector(num_workers=world)

    it = PrefetchIterator(data_cfg, start_step=start_step)
    losses = []
    t_total0 = time.time()
    try:
        for step in range(start_step, steps):
            batch = {k: v.to(dev) for k, v in next(it).items()}
            batch.update(frames_fn(step, batch["tokens"].shape[0]))
            t0 = time.time()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            for r, t in enumerate(step_times(dt, world)):
                monitor.beat(r)
                stragglers.observe(r, t)
            losses.append(loss)
            if step % log_every == 0 and rank == 0:
                print(f"step {step:5d}  loss {loss:8.4f}  "
                      f"gnorm {float(metrics['grad_norm']):7.3f}  {dt:6.2f}s",
                      flush=True)
            if ckpt and (step + 1) % ckpt_every == 0:
                whole = state if mesh is None else unshard_train_state(state)
                if rank == 0:
                    ckpt.save_async(step + 1, whole)
    finally:
        it.close()
        if ckpt:
            ckpt.close()
    return {"losses": losses, "state": state, "total_s": time.time() - t_total0,
            "start_step": start_step}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in --ckpt-dir")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--mesh", choices=("none", "production"), default="none",
                    help="production: train over make_production_mesh, one "
                         "process a card (REPRO_* variables; a world of one "
                         "without them)")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    mesh, owned = None, False
    if args.mesh == "production":
        owned = not dist.is_initialized()
        init_distributed(backend=lm_backend(args.device))
        mesh = make_production_mesh(device=args.device)
    try:
        _train(args, mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, mesh) -> None:
    """The run and its lines (rank 0 prints)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    setup = TrainSetup(micro_batches=args.micro, learning_rate=args.lr,
                       warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps)
    out = run_training(cfg, setup, args.steps, args.batch, args.seq,
                       ckpt_dir=args.ckpt_dir, resume=args.resume, mesh=mesh,
                       device=args.device)
    if process_index() != 0:
        return
    if mesh is not None:
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{process_count()} process(es)")
    if not out["losses"]:
        print(f"nothing left to run: the checkpoint is at step {out['start_step']}")
        return
    print(f"final loss {out['losses'][-1]:.4f} "
          f"(first {out['losses'][0]:.4f}) in {out['total_s']:.1f}s")


if __name__ == "__main__":
    main()
