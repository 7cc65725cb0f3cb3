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
