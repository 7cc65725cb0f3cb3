"""Recurrent mixers (``repro/models/ssm.py``): the Mamba-1 selective SSM
(Jamba's backbone) and RWKV6 "Finch" time-mix with data-dependent decay,
and its channel-mix.

Mamba is plain PyTorch, as the reference's is plain JAX.  Its prefill
keeps the reference's chunks of 128 steps, so ``[B, T, d_inner,
d_state]`` is materialized a chunk at a time and never over the whole
sequence; the last chunk takes whatever is left, so any S runs (the
reference's reshape refuses an S such as 257, ROADMAP C10).

Under grad mode (training) Mamba takes an out-of-place route: each
chunk's step chain runs under ``torch.utils.checkpoint``, as the
reference checkpoints its chunk, so the backward keeps only the chunk
boundaries' states and recomputes a chunk at a time.  Without grad the
in-place route above runs; the route is chosen by grad mode alone.

The WKV recurrence runs through ``kernels/rwkv6_scan``: the hand-written
CUDA kernel on the card, its plain version on the CPU; its gradient is
``WKV6Fn``'s plain recompute.  The kernel keeps the state on the chip
over the whole sequence, so the reference's chunked scan (a memory bound
for its backward) has no counterpart: the full sequence is one launch,
and a decode step is one launch with T=1 and the carried state.

Under the meshed train step and the tensor-parallel decode (DTensor
parameters on the ``model`` sub-mesh, ``sharding/ctx.py``) RWKV6 is
tensor-parallel: r, k, v, g and the decay are cut by heads, the WKV
kernel runs on each rank's heads through ``local_map`` (the replicated
bonus ``u`` sliced to them; a decode step's carried state is the cache's
shard of those heads), the output is made whole for ``ln_x`` (a
LayerNorm over all of d, not per head) and ``Wo`` is row-parallel; the
channel mix is column- then row-parallel.  The Mamba mixer is cut by
``d_inner``, as the reference's policy cuts it: ``in_proj`` (recut so a
rank holds the ``x`` and ``z`` halves of its own channels) and ``dt_proj``
column-parallel, the depthwise conv, ``exp(Δ·A)``, the chunked scan and
``D`` on the rank's channels, ``x_proj`` (recut from its output to its
input dimension) and ``out_proj`` row-parallel, their partial products
made whole (``sharding.gather`` recuts each block's leaves as it gathers
them, ``policy.MAMBA_CHANNELS`` says where each holds the channels).  The mixer runs
on the rank's local tensors between Megatron's *f* and *g*
(``ctx.local_input``, ``ctx.sum_over``), so the scan's per-step ops are
plain tensor ops; a decode step reads and updates the cache's own
``[B, d_inner/n, d_state]`` and ``[B, d_conv - 1, d_inner/n]`` shards."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models import nn
from repro_torch.sharding import ctx
from repro_torch.sharding.policy import MAMBA_CHANNELS


# ===========================================================================
# Mamba-1 selective SSM
# ===========================================================================
def mamba_init(gen, d: int, d_inner: int, d_state: int, d_conv: int,
               dtype=torch.bfloat16, device=None) -> dict:
    dt_rank = max(d // 16, 1)
    conv_w = torch.randn(d_conv, d_inner, generator=gen, device=device) / math.sqrt(d_conv)
    A = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": nn.linear_init(gen, d, 2 * d_inner, dtype=dtype, device=device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(d_inner, dtype=dtype, device=device),
        "x_proj": nn.linear_init(gen, d_inner, dt_rank + 2 * d_state, dtype=dtype,
                                 device=device),
        "dt_proj": nn.linear_init(gen, dt_rank, d_inner, bias=True, dtype=dtype,
                                  device=device),
        "A_log": torch.log(A).repeat(d_inner, 1),                  # [di, ds]
        "D": torch.ones(d_inner, dtype=torch.float32, device=device),
        "out_proj": nn.linear_init(gen, d_inner, d, dtype=dtype, device=device),
    }


def _channel_mesh(p: dict):
    """None for plain parameters; for DTensor ones their model sub-mesh,
    every leaf checked to be cut by d_inner (``policy.MAMBA_CHANNELS``),
    else a ValueError."""
    if not isinstance(p["in_proj"]["w"], DTensor):
        return None
    for path, (dim, _) in MAMBA_CHANNELS.items():
        leaf = p
        for k in path.split("/"):
            leaf = leaf[k]
        if leaf.placements[0] != Shard(dim):
            raise ValueError(f"the Mamba leaf {path} is {leaf.placements[0]}, "
                             f"not cut by d_inner (Shard({dim})) on the model axis")
    return p["in_proj"]["w"].device_mesh


def _mamba_ssm_inputs(p: dict, x: torch.Tensor, d_state: int, group):
    """delta, B, C in float32 from the convolved ``x`` ``[..., di]``; with
    ``group``, ``x`` the rank's channels: ``x_proj``'s row-parallel product
    made whole, and entering the rank's ``dt_proj`` columns and scan."""
    dbc = nn.linear(p["x_proj"], x)
    if group is not None:
        dbc = ctx.sum_over(dbc, [group])
    dbc = ctx.local_input(dbc, group)
    dt_rank = dbc.shape[-1] - 2 * d_state
    dt, Bm, Cm = dbc.split([dt_rank, d_state, d_state], dim=-1)
    delta = F.softplus(nn.linear(p["dt_proj"], dt).float())
    return delta, Bm.float(), Cm.float()


def mamba_forward(p: dict, u: torch.Tensor, *, d_state: int, d_conv: int,
                  chunk: int = 128) -> torch.Tensor:
    """Full-sequence prefill path.  u: ``[B, S, d]``, any S ≥ 1.

    The reference's two discretizations (its ``fused`` False materializes
    ``exp(Δ·A)`` and ``Δ·B·x`` per chunk, True per step; the config's
    ``mamba_fused_discretization`` picks one) give the same numbers, so
    the port has one: it materializes them a chunk of ``chunk`` steps at a
    time.  Without grad the state of each step is written over that step's
    ``Δ·B·x``; under grad mode each chunk is ``_mamba_chunk``, out of place
    and checkpointed.  The chunk's outputs are one batched product with C.
    On DTensor parameters (cut by d_inner, ``u`` replicated) each rank runs
    its channels on local tensors and the output is a ``Replicate()``
    DTensor."""
    mesh = _channel_mesh(p)
    if mesh is None:
        return _mamba_forward(p, u, d_state, d_conv, chunk, None)
    out = _mamba_forward(nn.local_tree(p), nn.whole_local(u, "the Mamba input"), d_state,
                         d_conv, chunk, mesh.get_group())
    return DTensor.from_local(out, mesh, [Replicate()], run_check=False)


def _mamba_forward(p: dict, u: torch.Tensor, d_state: int, d_conv: int, chunk: int,
                   group) -> torch.Tensor:
    """``mamba_forward`` on plain tensors: every channel, or with ``group``
    the rank's (its output made whole over ``group``)."""
    B, S, d = u.shape
    u = ctx.local_input(u, group)
    x, z = nn.linear(p["in_proj"], u).chunk(2, dim=-1)          # [B,S,di]
    di = x.shape[-1]

    # causal depthwise conv1d
    x_pad = F.pad(x, (0, 0, d_conv - 1, 0))
    x = sum(x_pad[:, i:i + S] * p["conv_w"][i] for i in range(d_conv))
    x = F.silu(x + p["conv_b"])

    delta, Bm, Cm = _mamba_ssm_inputs(p, x, d_state, group)    # [B,S,di], [B,S,ds]
    A = -torch.exp(p["A_log"])                                  # [di, ds]
    xf = x.float()
    h = torch.zeros(B, di, d_state, dtype=torch.float32, device=u.device)
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        if torch.is_grad_enabled():
            h, y = checkpoint(_mamba_chunk, h, delta[:, sl], xf[:, sl], Bm[:, sl],
                              Cm[:, sl], A, use_reentrant=False)
            ys.append(y)
            continue
        d_c = delta[:, sl]
        dA = torch.exp(d_c[..., None] * A)                      # [B,T,di,ds]
        hs = (d_c * xf[:, sl])[..., None] * Bm[:, sl, None, :]  # dBx, then h_t
        for t in range(hs.shape[1]):
            hs[:, t].addcmul_(dA[:, t], h)
            h = hs[:, t]
        ys.append(torch.einsum("btds,bts->btd", hs, Cm[:, sl]))
        h = h.clone()                                           # let hs go
        del dA, hs
    y = torch.cat(ys, dim=1) + xf * p["D"]
    y = y.to(u.dtype) * F.silu(z)
    out = nn.linear(p["out_proj"], y)
    return out if group is None else ctx.sum_over(out, [group])


def _mamba_chunk(h, d_c, x_c, B_c, C_c, A):
    """One chunk of the selective scan, out of place (differentiable):
    (the state after it, its outputs ``[B, T, di]``)."""
    dA = torch.exp(d_c[..., None] * A)                          # [B,T,di,ds]
    dBx = (d_c * x_c)[..., None] * B_c[:, :, None, :]
    hs = []
    for t in range(d_c.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        hs.append(h)
    return h, torch.einsum("btds,bts->btd", torch.stack(hs, 1), C_c)


def mamba_init_cache(B: int, d_inner: int, d_state: int, d_conv: int,
                     dtype=torch.float32, device=None) -> dict:
    return {
        "h": torch.zeros(B, d_inner, d_state, dtype=torch.float32, device=device),
        "conv": torch.zeros(B, d_conv - 1, d_inner, dtype=dtype, device=device),
    }


def mamba_step(p: dict, u_t: torch.Tensor, cache: dict, *, d_state: int,
               d_conv: int) -> tuple[torch.Tensor, dict]:
    """Single-token decode.  u_t: ``[B, 1, d]``.  On DTensor parameters the
    state is the cache's shard of the rank's channels (``h`` ``Shard(1)``,
    ``conv`` ``Shard(2)``): the step reads it and returns the new state as
    DTensors with the same placements, ``u_t`` and the output
    ``Replicate()``."""
    mesh = _channel_mesh(p)
    if mesh is None:
        return _mamba_step(p, u_t, cache, d_state, d_conv, None)
    for name, dim in (("h", 1), ("conv", 2)):
        if cache[name].placements[0] != Shard(dim):
            raise ValueError(f"the Mamba state {name} is {cache[name].placements[0]}, "
                             f"not the rank's channels (Shard({dim}))")
    out, state = _mamba_step(nn.local_tree(p), nn.whole_local(u_t, "the Mamba input"),
                             {name: cache[name].to_local() for name in ("h", "conv")},
                             d_state, d_conv, mesh.get_group())
    return (DTensor.from_local(out, mesh, [Replicate()], run_check=False),
            {name: DTensor.from_local(v, mesh, cache[name].placements, run_check=False)
             for name, v in state.items()})


def _mamba_step(p: dict, u_t: torch.Tensor, cache: dict, d_state: int, d_conv: int,
                group) -> tuple[torch.Tensor, dict]:
    """``mamba_step`` on plain tensors (with ``group``, the rank's channels
    and state)."""
    u_t = ctx.local_input(u_t, group)
    x, z = nn.linear(p["in_proj"], u_t[:, 0]).chunk(2, dim=-1)   # [B, di]
    conv_buf = torch.cat([cache["conv"], x[:, None]], dim=1)    # [B,dc,di]
    x = F.silu(torch.einsum("bcd,cd->bd", conv_buf, p["conv_w"]) + p["conv_b"])
    delta, Bm, Cm = _mamba_ssm_inputs(p, x, d_state, group)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(delta[..., None] * A)                        # [B,di,ds]
    dBx = (delta * x.float())[..., None] * Bm[:, None, :]
    h = dA * cache["h"] + dBx
    y = torch.einsum("bds,bs->bd", h, Cm) + x.float() * p["D"]
    y = y.to(u_t.dtype) * F.silu(z)
    out = nn.linear(p["out_proj"], y)[:, None]
    out = out if group is None else ctx.sum_over(out, [group])
    return out, {"h": h, "conv": conv_buf[:, 1:]}


# ===========================================================================
# RWKV6 (Finch): time-mix with data-dependent decay + channel-mix
# ===========================================================================
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
    if isinstance(w_dd, DTensor):       # by heads, as r, k, v (a reduce-scatter)
        w_dd = ctx.constrain(w_dd, "dp", None, "tp" if ctx.divides(H, "tp") else None)
    w = torch.exp(-torch.exp(p["w_base"] + w_dd.float()))       # [B,T,d] in (0,1)
    r = nn.split_heads(nn.linear(p["Wr"], xr), H, head_size)
    k = nn.split_heads(nn.linear(p["Wk"], xk), H, head_size)
    v = nn.split_heads(nn.linear(p["Wv"], xv), H, head_size)
    g = F.silu(nn.linear(p["Wg"], xg))
    r = ctx.constrain(r, "dp", None, "tp", None)
    k = ctx.constrain(k, "dp", None, "tp", None)
    v = ctx.constrain(v, "dp", None, "tp", None)
    return nn.split_heads(w, H, head_size), r, k, v, g


def _wkv_chunk(S0, w, r, k, v, u):
    """The WKV recurrence over ``T`` steps from state ``S0``.
    S0: ``[B, H, hd, hd]`` float32 or None (zeros); w, r, k, v:
    ``[B, T, H, hd]``; u: ``[H, hd]`` → (S_T, out ``[B, T, H, hd]`` float32)."""
    if isinstance(r, DTensor):
        out, S_T = _wkv_local_heads(w, r, k, v, u, S0)
    else:
        out, S_T = wkv_ops.wkv6(w, r, k, v, u, S0)
    return S_T, out


def _wkv_local_heads(w, r, k, v, u, S0):
    """The WKV kernel through ``local_map`` on each rank's heads (w, r, k, v
    ``Shard(2)``; ``u`` whole, sliced to the rank's heads, its gradient
    ``Partial``), or on every head where they are whole (the carried state
    too, when given)."""
    mesh = r.device_mesh
    u = u.redistribute(mesh, [Replicate()])
    if r.placements[0] != Shard(2):
        w, r, k, v = (t.redistribute(mesh, [Replicate()]) for t in (w, r, k, v))
        return local_map(wkv_ops.wkv6, out_placements=([Replicate()], [Replicate()]),
                         device_mesh=mesh)(w, r, k, v, u, S0)
    cut, H = [Shard(2)], r.to_local().shape[2]
    lo = mesh.get_local_rank() * H

    def body(w, r, k, v, u, S0):
        return wkv_ops.wkv6(w, r, k, v, u[lo:lo + H], S0)
    state = None if S0 is None else [Shard(1)]
    return local_map(body, out_placements=(cut, [Shard(1)]),
                     in_placements=(cut, cut, cut, cut, [Replicate()], state),
                     in_grad_placements=(cut, cut, cut, cut, [Partial()], state),
                     device_mesh=mesh)(w, r, k, v, u, S0)


def rwkv6_time_mix(p: dict, x: torch.Tensor, *, head_size: int) -> torch.Tensor:
    """Full-sequence path.  x: ``[B, S, d]``."""
    B, S, d = x.shape
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :S]
    w, r, k, v, g = _rwkv_mix_projections(p, x, x_prev, head_size)
    _, out = _wkv_chunk(None, w, r, k, v, p["u"])
    # ln_x normalizes over all of d: the heads made whole first
    out = ctx.constrain(nn.merge_heads(out).to(x.dtype), "dp", None, None)
    out = nn.layernorm(p["ln_x"], out)
    return nn.linear(p["Wo"], out * g)


def rwkv6_channel_mix(p: dict, x: torch.Tensor) -> torch.Tensor:
    B, S, d = x.shape
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :S]
    dx = x_prev - x
    xk = x + dx * p["mu_ck"]
    xr = x + dx * p["mu_cr"]
    k = torch.square(torch.relu(nn.linear(p["Wck"], xk)))
    k = ctx.constrain(k, "dp", None, "tp")    # column-parallel channel mix
    kv = nn.linear(p["Wcv"], k)
    if isinstance(kv, DTensor):
        # the row-parallel Partial reduce-scattered to Wcr's column cut:
        # the gate's product then stays local
        kv = ctx.constrain(kv, "dp", None, "tp")
    return torch.sigmoid(nn.linear(p["Wcr"], xr)) * kv


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
    """x_t: ``[B, 1, d]`` single-token decode.  On DTensors (the
    tensor-parallel decode) the carried state ``cache["S"]`` is the rank's
    heads (``Shard(1)``), the kernel runs on them and returns their
    ``S_T``; ``x_tm`` stays whole."""
    x_prev = cache["x_tm"][:, None]
    w, r, k, v, g = _rwkv_mix_projections(p, x_t, x_prev, head_size)
    S_T, out = _wkv_chunk(cache["S"], w, r, k, v, p["u"])
    # ln_x normalizes over all of d: the heads made whole first
    out = ctx.constrain(nn.merge_heads(out).to(x_t.dtype), "dp", None, None)
    out = nn.layernorm(p["ln_x"], out)
    y = nn.linear(p["Wo"], out * g)
    return y, dict(cache, S=S_T, x_tm=x_t[:, 0])


def rwkv6_channel_mix_step(p: dict, x_t: torch.Tensor,
                           cache: dict) -> tuple[torch.Tensor, dict]:
    x_prev = cache["x_cm"][:, None]
    dx = x_prev - x_t
    xk = x_t + dx * p["mu_ck"]
    xr = x_t + dx * p["mu_cr"]
    k = torch.square(torch.relu(nn.linear(p["Wck"], xk)))
    k = ctx.constrain(k, "dp", None, "tp")    # column-parallel channel mix
    kv = nn.linear(p["Wcv"], k)
    if isinstance(kv, DTensor):               # as rwkv6_channel_mix
        kv = ctx.constrain(kv, "dp", None, "tp")
    y = torch.sigmoid(nn.linear(p["Wcr"], xr)) * kv
    return y, dict(cache, x_cm=x_t[:, 0])
