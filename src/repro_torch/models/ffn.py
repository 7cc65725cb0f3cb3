"""Dense SwiGLU FFN (``repro/models/ffn.py``).  The routed MoE waits for
the MoE family (ROADMAP A9)."""
from __future__ import annotations

import torch

from repro_torch.models import nn


def dense_ffn_init(gen, d: int, d_ff: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    return nn.swiglu_init(gen, d, d_ff, dtype=dtype, device=device)


def dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return nn.swiglu(p, x)
