"""Neural-net primitives on plain parameter dicts (``repro/models/nn.py``).

Parameters are nested dicts of tensors in the reference's layout: a
linear weight is ``[d_in, d_out]`` and is applied as ``x @ w``, so weights
carry across without transposes.  The casting points are the
reference's: norms compute in float32 and scale after the cast back to
``x.dtype``; rotary angles are float32 and the result is cast back.
Initializers draw from an explicit ``torch.Generator`` on ``device``.

Under the meshed train step the parameters are DTensors on the ``model``
sub-mesh (``sharding/ctx.py``): ``linear`` and ``swiglu`` are then
column- and row-parallel by DTensor's matmul rules, ``embed`` looks up a
vocab-sharded table on each rank's rows of it and sums the ranks' rows,
``split_heads``/``merge_heads`` make whole the heads the axis does not
divide, and ``apply_rope`` runs on each rank's heads (``local_map``).  On
plain tensors every function is as it was."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def local_tree(tree):
    """Each DTensor of a parameter dict as its local shard (a differentiable
    ``to_local``: the gradient is the rank's part by the DTensor's
    placements); any other leaf as it is."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    return tree.to_local() if isinstance(tree, DTensor) else tree


def whole_local(x, what: str):
    """``x`` as a plain tensor: a DTensor's local copy, which must be whole
    on every rank (``Replicate()`` on every mesh dimension: a ``Partial``
    or a cut one would feed rank-local compute part-sums or a slice), else
    a ValueError; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    if any(pl != Replicate() for pl in x.placements):
        raise ValueError(f"{what} is {x.placements}, not whole on every rank (Replicate())")
    return x.to_local()


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
    """``table[ids]``.  A DTensor table gives a ``Replicate()`` DTensor:
    cut over the vocab (``Shard(0)`` on a mesh of more than one rank), each
    rank looks up the ids in its range, writes zeros for the others, and
    the ranks' rows are summed (the vocab-parallel embedding: an all-reduce,
    whose gradient passes to each rank's rows unchanged); otherwise the
    whole table's rows."""
    from repro_torch.sharding import ctx
    table = p["table"]
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    if table.placements[0] != Shard(0) or mesh.size() == 1:
        return ctx.enter(ctx.local(table)[ids], table)
    n = table.to_local().shape[0]
    lo = mesh.get_local_rank() * n

    def lookup(rows, ids):
        t = ids - lo
        inside = (t >= 0) & (t < n)
        mine = rows[t.clamp(0, n - 1)] * inside[..., None].to(rows.dtype)
        return ctx.sum_over(mine, [mesh.get_group()])
    return local_map(lookup, out_placements=[Replicate()], in_placements=([Shard(0)], None),
                     in_grad_placements=([Shard(0)], None), device_mesh=mesh)(table, ids)


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


# -- heads ----------------------------------------------------------------------
def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """``[B, S, n·hd]`` → ``[B, S, n, hd]``.  A DTensor whose head count the
    model axis does not divide is made whole first (a rank cannot hold part
    of a head, and ``apply_rope`` splits head_dim in halves)."""
    from repro_torch.sharding import ctx
    B, S = t.shape[:2]
    if isinstance(t, DTensor) and not ctx.divides(n, "tp"):
        t = ctx.constrain(t, "dp", None, None)
    return t.reshape(B, S, n, hd)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``[B, S, n, hd]`` → ``[B, S, n·hd]``.  A whole DTensor is flattened on
    each rank (``local_map``), so a gradient that comes back cut over the
    flat dimension is made whole before it is split into heads the model
    axis may not divide."""
    B, S, n, hd = t.shape
    if isinstance(t, DTensor) and t.placements[0] == Replicate():
        return local_map(lambda x: x.reshape(B, S, n * hd), out_placements=[Replicate()],
                         in_placements=([Replicate()],), device_mesh=t.device_mesh)(t)
    return t.reshape(B, S, n * hd)


# -- rotary position embeddings ----------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: ``[..., S, H, hd]``; positions: ``[..., S]``.  A DTensor ``x``
    (heads cut or replicated, head_dim whole) is rotated on each rank's
    part."""
    if isinstance(x, DTensor):
        pls = list(x.placements)
        return local_map(lambda t: apply_rope(t, positions, theta), out_placements=pls,
                         in_placements=(pls,), in_grad_placements=(pls,),
                         device_mesh=x.device_mesh)(x)
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                        # [hd/2]
    angles = positions[..., :, None].float() * freqs               # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]                       # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
