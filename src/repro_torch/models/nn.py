"""Neural-net primitives on plain parameter dicts (``repro/models/nn.py``).

Parameters are nested dicts of tensors in the reference's layout: a
linear weight is ``[d_in, d_out]`` and is applied as ``x @ w``, so weights
carry across without transposes.  The casting points are the
reference's: norms compute in float32 and scale after the cast back to
``x.dtype``; rotary angles are float32 and the result is cast back.
Initializers draw from an explicit ``torch.Generator`` on ``device``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _normal(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    # scaled in place: one float32 draw above the result at the peak
    return torch.randn(shape, generator=gen, device=device).mul_(scale).to(dtype)


def linear_init(gen, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.bfloat16, scale: float | None = None,
                device=None) -> dict:
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def embedding_init(gen, vocab: int, d: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    return {"table": _normal(gen, (vocab, d), 0.02, dtype, device)}


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def rmsnorm_init(d: int, dtype=torch.bfloat16, device=None) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * p["scale"]


def layernorm_init(d: int, dtype=torch.bfloat16, device=None) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"] + p["bias"]


def swiglu_init(gen, d: int, d_ff: int, dtype=torch.bfloat16,
                device=None) -> dict:
    return {
        "gate": linear_init(gen, d, d_ff, dtype=dtype, device=device),
        "up": linear_init(gen, d, d_ff, dtype=dtype, device=device),
        "down": linear_init(gen, d_ff, d, dtype=dtype, device=device),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    from repro_torch.sharding import ctx
    h = linear(p["gate"], x)
    u = linear(p["up"], x)
    if h.dim() == 3:
        # Megatron column-parallel: d_ff on the model axis
        h = ctx.constrain(h, "dp", None, "tp")
        u = ctx.constrain(u, "dp", None, "tp")
    return linear(p["down"], F.silu(h) * u)


# -- rotary position embeddings ----------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: ``[..., S, H, hd]``; positions: ``[..., S]``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                        # [hd/2]
    angles = positions[..., :, None].float() * freqs               # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]                       # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
