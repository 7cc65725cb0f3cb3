"""RWKV6 "Finch" time-mix with data-dependent decay, and channel-mix
(the RWKV6 half of ``repro/models/ssm.py``).

The WKV recurrence runs through ``kernels/rwkv6_scan``: the hand-written
CUDA kernel on the card, its plain version on the CPU.  The kernel keeps
the state on the chip over the whole sequence, so the reference's chunked
scan (a memory bound for its backward) has no counterpart: the full
sequence is one launch, and a decode step is one launch with T=1 and the
carried state.  Mamba waits for the hybrid family (ROADMAP A9)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models import nn


def rwkv6_init(gen, d: int, d_ff: int, head_size: int, dtype=torch.bfloat16,
               device=None) -> dict:
    H = d // head_size
    lora = max(d // 64, 32)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device).to(dtype)

    return {
        # time-mix
        "mu": uniform(5, d),
        "w_base": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "w_lora1": nn.linear_init(gen, d, lora, dtype=dtype, device=device),
        "w_lora2": nn.linear_init(gen, lora, d, dtype=dtype, scale=0.01,
                                  device=device),
        "Wr": nn.linear_init(gen, d, d, dtype=dtype, device=device),
        "Wk": nn.linear_init(gen, d, d, dtype=dtype, device=device),
        "Wv": nn.linear_init(gen, d, d, dtype=dtype, device=device),
        "Wg": nn.linear_init(gen, d, d, dtype=dtype, device=device),
        "u": torch.zeros(H, head_size, dtype=torch.float32, device=device),
        "Wo": nn.linear_init(gen, d, d, dtype=dtype, device=device),
        "ln_x": nn.layernorm_init(d, dtype=dtype, device=device),
        # channel-mix
        "mu_ck": uniform(d),
        "mu_cr": uniform(d),
        "Wck": nn.linear_init(gen, d, d_ff, dtype=dtype, device=device),
        "Wcv": nn.linear_init(gen, d_ff, d, dtype=dtype, device=device),
        "Wcr": nn.linear_init(gen, d, d, dtype=dtype, device=device),
    }


def _rwkv_mix_projections(p, x, x_prev, head_size):
    """Token-shift lerps + projections.  x/x_prev: ``[B, T, d]``."""
    B, T, d = x.shape
    H = d // head_size
    dx = x_prev - x
    xw = x + dx * p["mu"][0]
    xk = x + dx * p["mu"][1]
    xv = x + dx * p["mu"][2]
    xr = x + dx * p["mu"][3]
    xg = x + dx * p["mu"][4]
    # data-dependent decay (the Finch signature)
    w_dd = nn.linear(p["w_lora2"], torch.tanh(nn.linear(p["w_lora1"], xw)))
    w = torch.exp(-torch.exp(p["w_base"] + w_dd.float()))       # [B,T,d] in (0,1)
    r = nn.linear(p["Wr"], xr).reshape(B, T, H, head_size)
    k = nn.linear(p["Wk"], xk).reshape(B, T, H, head_size)
    v = nn.linear(p["Wv"], xv).reshape(B, T, H, head_size)
    g = F.silu(nn.linear(p["Wg"], xg))
    return w.reshape(B, T, H, head_size), r, k, v, g


def _wkv_chunk(S0, w, r, k, v, u):
    """The WKV recurrence over ``T`` steps from state ``S0``.
    S0: ``[B, H, hd, hd]`` float32 or None (zeros); w, r, k, v:
    ``[B, T, H, hd]``; u: ``[H, hd]`` → (S_T, out ``[B, T, H, hd]`` float32)."""
    out, S_T = wkv_ops.wkv6(w, r, k, v, u, S0)
    return S_T, out


def rwkv6_time_mix(p: dict, x: torch.Tensor, *, head_size: int) -> torch.Tensor:
    """Full-sequence path.  x: ``[B, S, d]``."""
    B, S, d = x.shape
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :S]
    w, r, k, v, g = _rwkv_mix_projections(p, x, x_prev, head_size)
    _, out = _wkv_chunk(None, w, r, k, v, p["u"])
    out = nn.layernorm(p["ln_x"], out.reshape(B, S, d).to(x.dtype))
    return nn.linear(p["Wo"], out * g)


def rwkv6_channel_mix(p: dict, x: torch.Tensor) -> torch.Tensor:
    B, S, d = x.shape
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :S]
    dx = x_prev - x
    xk = x + dx * p["mu_ck"]
    xr = x + dx * p["mu_cr"]
    k = torch.square(torch.relu(nn.linear(p["Wck"], xk)))
    return torch.sigmoid(nn.linear(p["Wcr"], xr)) * nn.linear(p["Wcv"], k)


def rwkv6_init_cache(B: int, d: int, head_size: int, dtype=torch.float32,
                     device=None) -> dict:
    H = d // head_size
    return {
        "S": torch.zeros(B, H, head_size, head_size, dtype=torch.float32,
                         device=device),
        "x_tm": torch.zeros(B, d, dtype=dtype, device=device),   # time-mix shift
        "x_cm": torch.zeros(B, d, dtype=dtype, device=device),   # channel-mix shift
    }


def rwkv6_time_mix_step(p: dict, x_t: torch.Tensor, cache: dict, *,
                        head_size: int) -> tuple[torch.Tensor, dict]:
    """x_t: ``[B, 1, d]`` single-token decode."""
    B, _, d = x_t.shape
    x_prev = cache["x_tm"][:, None]
    w, r, k, v, g = _rwkv_mix_projections(p, x_t, x_prev, head_size)
    S_T, out = _wkv_chunk(cache["S"], w, r, k, v, p["u"])
    out = nn.layernorm(p["ln_x"], out.reshape(B, 1, d).to(x_t.dtype))
    y = nn.linear(p["Wo"], out * g)
    return y, dict(cache, S=S_T, x_tm=x_t[:, 0])


def rwkv6_channel_mix_step(p: dict, x_t: torch.Tensor,
                           cache: dict) -> tuple[torch.Tensor, dict]:
    x_prev = cache["x_cm"][:, None]
    dx = x_prev - x_t
    xk = x_t + dx * p["mu_ck"]
    xr = x_t + dx * p["mu_cr"]
    k = torch.square(torch.relu(nn.linear(p["Wck"], xk)))
    y = torch.sigmoid(nn.linear(p["Wcr"], xr)) * nn.linear(p["Wcv"], k)
    return y, dict(cache, x_cm=x_t[:, 0])
