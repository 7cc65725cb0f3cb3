"""``meta`` stand-ins for every model input of the shape grid, and the
per-cell training setup (``repro/launch/specs.py``).

No memory is allocated here: batches, decode caches and the full train
state (parameters, AdamW moments, EF residuals) are tensors on the
``meta`` device, which carry a shape and a dtype and no data.
``launch/dryrun.py`` runs a cell's step on them, where the reference
lowers its step on ``jax.ShapeDtypeStruct``s."""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train.trainer import DTYPES, TrainSetup, abstract_train_state

# cross-attention memory length used by enc-dec decode cells (the encoder
# side of seamless; independent of the 32k/500k self-cache stress length)
ENCDEC_MEMORY_LEN = 4096


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_setup(cfg: ModelConfig, shape: ShapeSpec) -> TrainSetup:
    """Per-cell training configuration (microbatching + optimizer dtypes)."""
    big = cfg.param_count() > 5e10
    return TrainSetup(
        micro_batches=8 if shape.global_batch >= 64 else 1,
        moment_dtype="bfloat16" if big else "float32",
    )


def input_specs(arch_id: str, shape_name: str, cfg: ModelConfig | None = None):
    """Returns (kind, meta args) for the cell's step function:

      train  -> {"batch": {tokens, targets[, frames | frontend_embeds]}}
      decode -> {"cache": <meta cache>, "tokens": [B, 1]}
      prefill-> {"batch": like train (forward only)}
    """
    return inputs_for(cfg or get_config(arch_id), SHAPES[shape_name])


def inputs_for(cfg: ModelConfig, shape: ShapeSpec):
    """``input_specs`` for any ``ShapeSpec``, the grid's or another."""
    B, S = shape.global_batch, shape.seq_len
    dt = DTYPES[cfg.dtype]

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            batch = {
                "frames": _meta((B, S, cfg.d_model), dt),     # frontend stub
                "tokens": _meta((B, S), torch.int32),
                "targets": _meta((B, S), torch.int32),
            }
        elif cfg.family == "vlm":
            P = cfg.frontend_positions
            batch = {
                "frontend_embeds": _meta((B, P, cfg.d_model), dt),  # CLIP stub
                "tokens": _meta((B, S - P), torch.int32),
                "targets": _meta((B, S - P), torch.int32),
            }
        else:
            batch = {
                "tokens": _meta((B, S), torch.int32),
                "targets": _meta((B, S), torch.int32),
            }
        return shape.kind, {"batch": batch}

    # decode: one new token against a seq_len-deep cache
    enc_len = ENCDEC_MEMORY_LEN if cfg.family == "encdec" else 0
    cache = lm.init_cache(cfg, batch=B, max_seq=S, device="meta", enc_len=enc_len)
    return "decode", {"cache": cache, "tokens": _meta((B, 1), torch.int32)}


def abstract_state_for(cfg: ModelConfig, shape: ShapeSpec):
    return abstract_train_state(cfg, train_setup(cfg, shape))
