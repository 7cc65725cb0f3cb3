"""Plain PyTorch version of the flash-attention kernel.

The function of ``repro/kernels/flash_attention/ref.py::attention_ref``,
which the Pallas kernel is held against: GQA attention with the whole
score matrix materialized, in float32, output in q's dtype.  Any S works,
ragged or not, and non-causal attention takes keys of a length of their
own (cross-attention over an encoder's memory)."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q ``[B, S, H, hd]``; k, v ``[B, Skv, Hkv, hd]`` (Skv = S when causal)
    → ``[B, S, H, hd]``."""
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, S, Hkv, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, Skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
