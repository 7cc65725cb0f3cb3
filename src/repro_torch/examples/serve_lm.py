"""Serve a small model with batched requests: static-batch generation plus
the continuous-batching scheduler (slots recycle as requests finish).

Port of ``examples/serve_lm.py``:

  python -m repro_torch.examples.serve_lm [--device cpu]

Random weights from a seeded generator, as the reference's
``PRNGKey(0)``; the reference's keys 1-3 (prompts, the static batch's
sampler, the batcher's) become seeds ``SEED + 1`` to ``SEED + 3``.  The
reference's printed lines are kept as they are."""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.continuous import ContinuousBatcher, Request
from repro_torch.serve.engine import Engine, SamplingParams


# the reference's numbers
MAX_SEQ, BATCH, PROMPT_LEN, NEW_TOKENS = 96, 4, 12, 16
REQUESTS, SLOTS, SEED = 8, 3, 0


def run(device: str | torch.device | None = None) -> dict:
    """The reference's serving example on llama3-8b's smoke config, on
    ``device`` (default CUDA).  Prints its lines; returns the static batch's
    tokens, its wall seconds and the finished requests."""
    dev = resolve_device(device)
    seeded = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    cfg = get_config("llama3-8b", smoke=True)
    params = lm.init_params(cfg, seeded(SEED), dev)

    print("== static batched generation ==")
    eng = Engine(cfg, params, max_seq=MAX_SEQ, batch_size=BATCH, device=dev)
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=seeded(SEED + 1), device=dev)
    t0 = time.time()
    out = eng.generate(seeded(SEED + 2), prompts, max_new_tokens=NEW_TOKENS,
                       sp=SamplingParams(temperature=0.8, top_k=40)).cpu()
    dt = time.time() - t0
    print(f"generated {tuple(out.shape)} tokens in {dt:.1f}s "
          f"({out.numel() / dt:.1f} tok/s incl. compile)")
    print(out[:, :8].tolist())

    print(f"\n== continuous batching: {REQUESTS} requests through {SLOTS} slots ==")
    cb = ContinuousBatcher(cfg, params, max_seq=MAX_SEQ, n_slots=SLOTS,
                           eos_id=-1, sp=SamplingParams(temperature=0.7, top_k=20),
                           device=dev)
    for rid in range(REQUESTS):
        cb.submit(Request(rid=rid, prompt=[1 + rid, 5, 9],
                          max_new_tokens=4 + rid % 3))
    done = cb.run(seeded(SEED + 3), max_steps=200)
    for r in done:
        print(f"  request {r.rid}: {len(r.out)} tokens -> {r.out}")
    print(f"served {len(done)} requests with {SLOTS} slots")
    return dict(tokens=out, seconds=dt, done=done)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
