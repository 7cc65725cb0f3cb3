"""FFN layers: dense SwiGLU and routed top-k MoE with shared experts
(``repro/models/ffn.py``).

The MoE keeps the reference's capacity discipline and its sort-free
rank-scatter dispatch, per sequence: tokens are ranked within their
expert by a cumsum over the one-hot routing matrix, written into a
per-expert ``[B, E, cap + 1, d]`` buffer whose last slot is the drop bin,
run through stacked-expert products over the whole buffer, and combined
back with the router weights.  The Switch aux loss of a batch whose rows
are cut over the data axes sums its statistics over them
(``ctx.batch_sum``), so it is the global batch's, as GSPMD gives the
reference.  The expert products are plain ``bmm``s, as the reference left
them to XLA outside any Pallas kernel.

With DTensor parameters on the ``model`` sub-mesh (the meshed train step,
the dry-run's prefill, the tensor-parallel decode) the routing is computed
once on every rank from the replicated input and router, and the experts
are cut as the reference's policy cuts them (``docs/torch_lm_sharding.md``):

* expert parallelism where the axis divides the experts: each rank fills
  the dispatch buffer for its own ``E/n`` experts only, ``[B, E/n, cap +
  1, d]``, and runs their products (the tokens are already on every rank:
  no all-to-all);
* where it does not, each expert's ``gate``/``up`` cut by d_ff
  (column-parallel) and ``down`` row-parallel, every expert on every rank;
  the combine is linear in the experts' outputs, so it runs on the partial
  ones.

Either way the rank's combine, and a shared expert's cut product, is a
partial ``[B, S, d]`` made whole once (``ctx.sum_over``, Megatron's *g*);
the dispatched tokens and the combine weights enter through
``ctx.local_input`` (*f*), whose backward makes each rank's partial
gradient whole.  The aux loss reads the replicated routing only, so its
gradient is each rank's alike and is not summed over the axis."""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

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
    the router's continuous outputs do not tie in practice.  On DTensors
    (``x`` and the router replicated on the model axis) every rank routes
    its local copy: the routing is plain tensors, the same on each rank
    (any other layout raises)."""
    x = nn.whole_local(x, "the MoE's input")
    B, S, _ = x.shape
    E = p["gate"].shape[0]
    K = experts_per_token
    cap = int(capacity_factor * S * K / E) + 1
    logits = x.float() @ nn.whole_local(p["router"]["w"], "the router")  # [B,S,E]
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
    Serving does not compute it; training does (``lm._train_ffn``)."""
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

    On DTensor parameters the experts are cut on the model axis (the
    module docstring): by experts where the placements put them there
    (``Shard(0)`` of ``[E, d, d_ff]``), else by each expert's d_ff
    (``gate``/``up`` ``Shard(2)``, ``down`` ``Shard(1)``); a shared expert
    column- then row-parallel (``Shard(1)``, ``Shard(0)``); ``x``
    replicated.  Any other layout raises.  The output is a ``Replicate()``
    DTensor."""
    gate = p["gate"]
    if not isinstance(gate, DTensor):
        return _experts(p, x, r, 0, None)
    mesh = gate.device_mesh
    pl = {k: v.placements[0] for k, v in p.items() if isinstance(v, DTensor)}
    ep = pl["gate"] == pl["up"] == pl["down"] == Shard(0)
    by_ff = pl["gate"] == pl["up"] == Shard(2) and pl["down"] == Shard(1)
    s = p.get("shared")
    shared_cut = s is None or (
        s["gate"]["w"].placements[0] == s["up"]["w"].placements[0] == Shard(1)
        and s["down"]["w"].placements[0] == Shard(0))
    if not ((ep or by_ff) and shared_cut):
        raise ValueError(f"the MoE's weights are cut neither by experts nor by d_ff on "
                         f"the model axis: {pl}")
    local = nn.local_tree({k: v for k, v in p.items() if k != "router"})
    lo = mesh.get_local_rank() * local["gate"].shape[0] if ep else 0
    out = _experts(local, nn.whole_local(x, "the MoE's input"), r, lo, mesh.get_group())
    return DTensor.from_local(out, mesh, [Replicate()], run_check=False)


def _experts(p: dict, x: torch.Tensor, r: Routing, lo: int, group) -> torch.Tensor:
    """The experts ``p`` holds (``[E_l, d, f]`` from expert ``lo``; every
    expert at a slice of d_ff when ``E_l`` is all of them) on plain ``x``
    routed by ``r``: the MoE's output, or with ``group`` this rank's part
    of it made whole over ``group``.

    Kept rows are written by plain indexing: ranks are unique within an
    expert, so only the drop bin takes several rows, and whichever lands
    there is masked out by ``keep`` at the gather (the reference sums
    them there); a rank's drop bin takes the other ranks' experts' rows
    too.  The combine adds the K weighted choices of a token in the order
    k = 0…K-1, the order of the reference's scatter-add, so a bf16 output
    rounds as it does and two runs give the same bits."""
    B, S, d = x.shape
    El, K = p["gate"].shape[0], r.top_w.shape[-1]
    C = r.cap + 1
    x = ctx.local_input(x, group)
    top_w = ctx.local_input(r.top_w, group)
    expert, slot, keep = r.expert, r.slot, r.keep
    if El != r.onehot.shape[-1]:                 # this rank's experts only
        mine = (expert >= lo) & (expert < lo + El)
        expert = torch.where(mine, expert - lo, 0)
        slot = torch.where(mine, slot, r.cap)
        keep = keep & mine
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    tok = torch.arange(S, device=x.device).repeat_interleave(K)     # [S·K]
    buf = x.new_zeros(B, El, C, d)
    buf[rows, expert, slot] = x[:, tok]

    # stacked-expert FFN: E is the batch of the products
    xb = buf.transpose(0, 1).reshape(El, B * C, d)
    h = torch.bmm(xb, p["gate"])
    u = torch.bmm(xb, p["up"])
    y = torch.bmm(F.silu(h) * u, p["down"])                        # [E,B·C,d]
    y = y.reshape(El, B, C, d).transpose(0, 1)                      # [B,E,C,d]

    gathered = y[rows, expert, slot]                                # [B,S·K,d]
    gathered = torch.where(keep[..., None], gathered, 0.0)
    weighted = (gathered * top_w.reshape(B, S * K, 1).to(y.dtype)).reshape(B, S, K, d)
    out = x.new_zeros(B, S, d)
    for k in range(K):
        out = out + weighted[:, :, k]
    if "shared" in p:
        out = out + nn.swiglu(p["shared"], x)
    return out if group is None else ctx.sum_over(out, [group])


def moe_ffn(p: dict, x: torch.Tensor, *, experts_per_token: int,
            capacity_factor: float = 1.25,
            router_aux_coef: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d]`` → (output ``[B, S, d]``, the Switch aux loss), as
    the reference's ``moe_ffn`` returns them."""
    r = moe_route(p, x, experts_per_token=experts_per_token,
                  capacity_factor=capacity_factor)
    return moe_apply(p, x, r), moe_aux(r, router_aux_coef)
