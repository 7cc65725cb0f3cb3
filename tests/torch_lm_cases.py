"""LM cases shared by the port's CPU tests, its card tests and
``chip_smoke.py``.  Imports nothing of JAX."""
import dataclasses

import numpy as np
import torch

# the reference tests' two scenarios (tests/test_serve.py) and a recycled
# slot: (n_slots, max_seq, [(prompt, max_new_tokens), ...])
BATCHER_SCENARIOS = {
    "five_on_two": (2, 64, [([1 + rid, 2, 3], 4) for rid in range(5)]),
    "two_on_one": (1, 64, [([5], 2), ([9], 2)]),
    "recycled_slot": (1, 64, [([7, 8, 9], 5)] * 3),
}


def smoke_lm(arch: str, seed: int):
    """(float32 smoke config of ``arch``, its seeded CPU parameters).  An
    RWKV config's bonus ``u`` is drawn at 0.5 (it starts at 0)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    if cfg.family == "ssm":
        u = cpu["layers"]["pos0"]["mixer"]["u"]
        u.copy_(torch.randn(u.shape, generator=torch.Generator().manual_seed(seed + 1))
                * 0.5)
    return cfg, cpu


def frontend_inputs(cfg, batch: int, seed: int, enc_len: int = 0) -> dict:
    """A config's inputs beside its tokens, as float32 numpy arrays drawn
    from one seeded generator at the token embeddings' scale (0.02): a
    vlm's ``frontend_embeds`` ``[batch, frontend_positions, d]`` (the
    patch embeddings its frontend stub stands for), an encdec's ``frames``
    ``[batch, enc_len, d]`` (the encoder's input); nothing for the other
    families."""
    rng = np.random.default_rng(seed)
    if cfg.encoder_layers:
        return {"frames": (rng.normal(size=(batch, enc_len, cfg.d_model)) * 0.02
                           ).astype(np.float32)}
    if cfg.frontend == "patches":
        shape = (batch, cfg.frontend_positions, cfg.d_model)
        return {"frontend_embeds": (rng.normal(size=shape) * 0.02).astype(np.float32)}
    return {}


def train_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """A training batch as numpy arrays from one seeded generator: int32
    ``tokens`` and ``targets`` ``[batch, seq]`` (the targets the tokens
    shifted by one), and the config's ``frontend_inputs`` (an encdec's
    ``frames`` as long as the tokens)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy(),
            **frontend_inputs(cfg, batch, seed + 1, enc_len=seq)}


def on_device(tree, device):
    """A copy of a nest of dicts, tuples (a train state's NamedTuples) and
    tensors on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(on_device(v, device) for v in tree))
    return tree


def warm_train_state(arch: str, setup, steps: int, seed: int):
    """(float32 smoke config of ``arch``, its train state on the CPU after
    ``steps`` steps of ``setup`` on ``train_batch`` draws, the next step's
    batch as tensors).  A step compared across devices starts here: from
    zero moments Adam's first update ``g / (|g| + eps)`` turns the
    rounding of a near-zero gradient into a whole step of the learning
    rate, which a few steps of accumulated second moments damp."""
    from repro_torch.train import trainer

    cfg, cpu = smoke_lm(arch, seed)
    state = trainer.finish_init(cpu, setup)
    step = trainer.make_train_step(cfg, setup)
    draw = lambda i: {k: torch.from_numpy(v)  # noqa: E731
                      for k, v in train_batch(cfg, 4, 16, seed=seed + i).items()}
    for i in range(steps):
        state, _ = step(state, draw(i))
    return cfg, state, draw(steps)
