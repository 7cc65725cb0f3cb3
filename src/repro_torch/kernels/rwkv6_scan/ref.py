"""Plain PyTorch version of the WKV6 kernel.

The function of ``repro/kernels/rwkv6_scan/ref.py::wkv6_ref`` (and of
``repro/models/ssm._wkv_chunk``): a loop over time with an ``[hd, hd]``
float32 state per (batch, head)."""
from __future__ import annotations

import torch


def wkv6_ref(w, r, k, v, u, S0=None):
    """w, r, k, v ``[B, T, H, hd]`` (w = per-step decay in (0, 1)); u
    ``[H, hd]`` bonus; S0 ``[B, H, hd, hd]`` or None for zeros.
    Returns (out ``[B, T, H, hd]`` float32, S_T ``[B, H, hd, hd]`` float32):

      S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ
      out_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
    """
    B, T, H, hd = r.shape
    S = (torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
         if S0 is None else S0.float())
    w, r, k, v = (a.float() for a in (w, r, k, v))
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # [B,H,hd,hd]
        outs.append(torch.einsum("bhij,bhi->bhj", S + uf * kv, r[:, t]))
        S = w[:, t, :, :, None] * S + kv
    out = (torch.stack(outs, 1) if outs else
           torch.zeros(B, 0, H, hd, dtype=torch.float32, device=r.device))
    return out, S
