"""Int8 error-feedback gradient compression (``repro/train/compression.py``).

Each gradient leaf is quantized to int8 with a per-leaf scale, and the
quantization error is kept as a residual that is added back the next step
(error feedback).  The reference applies it before the cross-pod
all-reduce; the port runs on one device (ROADMAP A13.7), where it is the
same arithmetic on the accumulated gradients.  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the int8 values are the reference's."""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (q int8, scale float32)."""
    amax = torch.max(torch.abs(x)).float()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_leaf(g: torch.Tensor, residual: torch.Tensor):
    """Error-feedback compress one gradient leaf: (compressed g in g's
    dtype, new residual in the residual's dtype)."""
    corrected = g.float() + residual.float()
    q, scale = quantize_int8(corrected)
    deq = dequantize_int8(q, scale)
    return deq.to(g.dtype), (corrected - deq).to(residual.dtype)


def ef_compress_grads(grads, residuals):
    """EF-int8 on every leaf of a tree: (compressed grads, residuals)."""
    both = tree_map(ef_compress_leaf, grads, residuals)
    return tree_map(lambda pair: pair[0], both), tree_map(lambda pair: pair[1], both)


def compression_error(g: torch.Tensor) -> torch.Tensor:
    """Relative L2 error of one int8 round trip (no error feedback)."""
    q, s = quantize_int8(g)
    deq = dequantize_int8(q, s)
    return torch.linalg.norm(deq - g) / torch.clamp(torch.linalg.norm(g), min=1e-12)
