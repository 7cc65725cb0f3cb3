"""GQA attention (``repro/models/attention.py``): the full-sequence path
through the flash-attention kernel, and the cached decode step.

``flash_attention`` is where the reference calls its pure-JAX twin of the
Pallas kernel (same online softmax); here it goes through
``kernels/flash_attention``: the hand-written CUDA kernel on the card,
its plain version on the CPU; its gradient is ``FlashAttentionFn``'s
plain float32 recompute.  The kernel tiles itself, so the
reference's ``q_chunk``/``kv_chunk`` have no counterpart, and it masks a
ragged S instead of asserting it away.  Non-causal attention takes keys
of their own length: the reference's twin cuts k/v into chunks by q's
length, so its cross-attention over a memory longer than q reads only
the first S rows (ROADMAP C10); here every row is read.  Decode attention is a plain
masked softmax over the cache, as in the reference.  The
sequence-parallel variant waits for ``torch.distributed`` (ROADMAP
A13.7)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q ``[B, S, H, hd]``; k, v ``[B, Skv, Hkv, hd]`` (Skv = S when
    causal) → ``[B, S, H, hd]``."""
    return fa_ops.flash_attention(q, k, v, causal=causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """q ``[B, 1, H, hd]`` (one new token) against the first ``cache_len``
    positions of k/v_cache ``[B, Smax, Hkv, hd]``."""
    B, _, H, hd = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)
    s = s.masked_fill(pos >= cache_len, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def update_kv_cache(k_cache, v_cache, k_new, v_new, cache_len: int):
    """Write ``[B, T, Hkv, hd]`` new keys/values at position ``cache_len``,
    in place (the reference returns updated copies), and return the
    caches."""
    T = k_new.shape[1]
    k_cache[:, cache_len:cache_len + T] = k_new.to(k_cache.dtype)
    v_cache[:, cache_len:cache_len + T] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
