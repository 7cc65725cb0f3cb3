"""FFN layers: dense SwiGLU and routed top-k MoE with shared experts
(``repro/models/ffn.py``).

The MoE keeps the reference's capacity discipline and its sort-free
rank-scatter dispatch, per sequence: tokens are ranked within their
expert by a cumsum over the one-hot routing matrix, written into a
per-expert ``[B, E, cap + 1, d]`` buffer whose last slot is the drop bin,
run through stacked-expert products over the whole buffer, and combined
back with the router weights.  The reference's sharding hints
(``ctx.constrain``) sit at its points: no-ops without a mesh, and on the
meshed train step's plain local tensors (compute on the model axis stays
replicated).  The Switch aux loss of a batch whose rows are cut over the
data axes sums its statistics over them (``ctx.batch_sum``), so it is the
global batch's, as GSPMD gives the reference.  The expert products are
plain ``bmm``s, as the reference left them to XLA outside any Pallas
kernel."""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.sharding import ctx


def dense_ffn_init(gen, d: int, d_ff: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    return nn.swiglu_init(gen, d, d_ff, dtype=dtype, device=device)


def dense_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return nn.swiglu(p, x)


def moe_init(gen, d: int, d_ff: int, num_experts: int, num_shared: int,
             dtype=torch.bfloat16, device=None) -> dict:
    """The reference's tree, shapes, dtypes and scales: the router stays
    float32 at 0.02; the stacked experts are drawn at ``1/sqrt(d)``."""
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": {"w": nn._normal(gen, (d, num_experts), 0.02, torch.float32, device)},
        "gate": nn._normal(gen, (num_experts, d, d_ff), scale, dtype, device),
        "up": nn._normal(gen, (num_experts, d, d_ff), scale, dtype, device),
        "down": nn._normal(gen, (num_experts, d_ff, d), scale, dtype, device),
    }
    if num_shared:
        p["shared"] = nn.swiglu_init(gen, d, num_shared * d_ff, dtype=dtype,
                                     device=device)
    return p


@dataclasses.dataclass
class Routing:
    """One MoE layer's routing of ``x [B, S, d]``, flattened per sequence
    in the reference's ``[S·K]`` order (token-major, then k)."""
    probs: torch.Tensor        # [B, S, E] float32 softmax of the router
    top_w: torch.Tensor        # [B, S, K] float32, renormalized
    expert: torch.Tensor       # [B, S·K] int64, the chosen expert
    slot: torch.Tensor         # [B, S·K] int64, rank in its expert, or cap
    keep: torch.Tensor         # [B, S·K] bool, rank < cap
    onehot: torch.Tensor       # [B, S·K, E] int64, ``expert`` one-hot
    cap: int


def moe_route(p: dict, x: torch.Tensor, *, experts_per_token: int,
              capacity_factor: float = 1.25) -> Routing:
    """The float32 router, top-K with the weights renormalized by
    ``max(sum, 1e-9)``, and each choice's slot in its expert's buffer.
    ``torch.topk`` and ``lax.top_k`` may order exact ties differently;
    the router's continuous outputs do not tie in practice."""
    B, S, _ = x.shape
    E = p["gate"].shape[0]
    K = experts_per_token
    cap = int(capacity_factor * S * K / E) + 1
    logits = x.float() @ p["router"]["w"]                           # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)                     # [B,S,K]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    expert = top_e.reshape(B, S * K)
    onehot = F.one_hot(expert, E)                                   # [B,S·K,E]
    rank = torch.cumsum(onehot, dim=1) - onehot
    my_rank = torch.gather(rank, 2, expert[..., None])[..., 0]
    keep = my_rank < cap
    slot = torch.where(keep, my_rank, cap)                          # drop bin
    return Routing(probs, top_w, expert, slot, keep, onehot, cap)


def moe_aux(r: Routing, router_aux_coef: float = 0.01) -> torch.Tensor:
    """The Switch load-balancing loss of a routing, a float32 scalar.
    Serving does not compute it; training (ROADMAP A10) will."""
    B, SK, E = r.onehot.shape
    n = ctx.batch_split()
    if n == 1:
        me = r.probs.mean((0, 1))                                   # [E]
        ce = r.onehot.sum((0, 1)).float() / (B * SK)
    else:                       # this rank's rows of the global batch
        me = ctx.batch_sum(r.probs.sum((0, 1))) / (n * B * r.probs.shape[1])
        ce = ctx.batch_sum(r.onehot.sum((0, 1))).float() / (n * B * SK)
    return router_aux_coef * E * torch.sum(me * ce)


def moe_apply(p: dict, x: torch.Tensor, r: Routing) -> torch.Tensor:
    """``x [B, S, d]`` routed by ``r`` → the MoE's output ``[B, S, d]``.

    Kept rows are written by plain indexing: ranks are unique within an
    expert, so only the drop bin takes several rows, and whichever lands
    there is masked out by ``keep`` at the gather (the reference sums
    them there).  The combine adds the K weighted choices of a token in
    the order k = 0…K-1, the order of the reference's scatter-add, so a
    bf16 output rounds as it does and two runs give the same bits."""
    B, S, d = x.shape
    E, K = p["gate"].shape[0], r.top_w.shape[-1]
    C = r.cap + 1
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    tok = torch.arange(S, device=x.device).repeat_interleave(K)     # [S·K]
    buf = x.new_zeros(B, E, C, d)
    buf[rows, r.expert, r.slot] = x[:, tok]
    ep = E % max(ctx.axis_size("tp"), 1) == 0
    # expert parallelism: experts on the model axis; else TP over d_ff
    buf = ctx.constrain(buf, "dp", "tp" if ep else None, None, None)

    # stacked-expert FFN: E is the batch of the products
    xb = buf.transpose(0, 1).reshape(E, B * C, d)
    h = torch.bmm(xb, p["gate"])
    u = torch.bmm(xb, p["up"])
    # the reference's [B,E,C,f] hints in this [E,B·C,f] layout
    h_axes = ("tp", "dp", None) if ep else (None, "dp", "tp")
    h, u = ctx.constrain(h, *h_axes), ctx.constrain(u, *h_axes)
    y = torch.bmm(F.silu(h) * u, p["down"])                         # [E,B·C,d]
    y = y.reshape(E, B, C, d).transpose(0, 1)                       # [B,E,C,d]
    y = ctx.constrain(y, "dp", "tp" if ep else None, None, None)

    gathered = y[rows, r.expert, r.slot]                            # [B,S·K,d]
    gathered = torch.where(r.keep[..., None], gathered, 0.0)
    weighted = (gathered * r.top_w.reshape(B, S * K, 1).to(y.dtype)).reshape(B, S, K, d)
    out = x.new_zeros(B, S, d)
    for k in range(K):
        out = out + weighted[:, :, k]
    out = ctx.constrain(out, "dp", None, None)
    if "shared" in p:
        out = out + nn.swiglu(p["shared"], x)
    return out


def moe_ffn(p: dict, x: torch.Tensor, *, experts_per_token: int,
            capacity_factor: float = 1.25,
            router_aux_coef: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d]`` → (output ``[B, S, d]``, the Switch aux loss), as
    the reference's ``moe_ffn`` returns them."""
    r = moe_route(p, x, experts_per_token=experts_per_token,
                  capacity_factor=capacity_factor)
    return moe_apply(p, x, r), moe_aux(r, router_aux_coef)
