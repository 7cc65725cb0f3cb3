"""Language-model builder, forward only (``repro/models/lm.py``).

One parameter layout and the serving entry points:

  init_params(cfg, gen, device)              -> parameter dict
  prefill_forward(cfg)(params, batch)        -> (last logits, K/V taps)
  init_cache(cfg, batch, max_seq, device)    -> decode state
  serve_step(cfg)(params, cache, tokens)     -> (logits, cache)

Ported families: ``dense`` (GQA transformer, with the parallel block),
``moe`` (the routed top-k FFN of ``ffn.moe_ffn``, shared experts
included) and ``ssm`` (RWKV6 Finch); a config of another family raises
``NotImplementedError`` naming the ROADMAP item that ports it.  Training
(``train_loss``, and so the MoE's auxiliary loss, which serving does not
compute: the reference's serving discards it) waits for ROADMAP A10; the hybrid Mamba, the
encoder and the modality frontends for A9.  Parameters
keep the reference's tree: per-position leaves stacked over the
``num_blocks`` identical blocks ``[nb, ...]``, run here by a Python loop
over the blocks (no remat: there is no backward).  Attention
goes through the flash-attention kernel and the RWKV6 recurrence through
the WKV6 kernel; everything else is plain PyTorch, as the reference left
it to XLA."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import nn, ssm
from repro_torch.models.config import ModelConfig

Params = dict
Batch = dict


def _dt(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not cover."""
    if cfg.family not in ("dense", "moe", "ssm") or cfg.attn_every:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (hybrid Mamba, encdec, vlm) "
            "is not ported yet: ROADMAP A9")
    if cfg.encoder_layers or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoders and modality frontends are not ported yet: "
            "ROADMAP A9")


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn: Callable, a, b):
    if isinstance(a, dict):
        return {k: _tree_zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _block(layers: Params, b: int) -> Params:
    """Block ``b``'s parameters (or cache): views into the stacked leaves."""
    return _tree_map(lambda a: a[b], layers)


# ===========================================================================
# Parameter construction
# ===========================================================================
def _attn_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": nn.linear_init(gen, d, h * hd, bias=cfg.qkv_bias, dtype=dtype, device=device),
        "wk": nn.linear_init(gen, d, hkv * hd, bias=cfg.qkv_bias, dtype=dtype, device=device),
        "wv": nn.linear_init(gen, d, hkv * hd, bias=cfg.qkv_bias, dtype=dtype, device=device),
        "wo": nn.linear_init(gen, h * hd, d, dtype=dtype, device=device),
    }


def _ffn_init(gen, cfg: ModelConfig, kind: str, dtype, device) -> Params:
    if kind == "moe":
        return ffn_lib.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.num_experts,
                                cfg.num_shared_experts, dtype=dtype, device=device)
    return ffn_lib.dense_ffn_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                                  device=device)


def _block_position_init(gen, cfg: ModelConfig, mixer: str, fkind: str, dtype,
                         device) -> Params:
    p: Params = {"norm1": nn.rmsnorm_init(cfg.d_model, dtype=dtype, device=device)}
    if mixer == "rwkv":
        # RWKV folds its FFN (channel-mix) into the mixer params
        p["mixer"] = ssm.rwkv6_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.rwkv_head_size, dtype=dtype, device=device)
    else:
        p["mixer"] = _attn_init(gen, cfg, dtype, device)
        p["ffn"] = _ffn_init(gen, cfg, fkind, dtype, device)
    p["norm2"] = nn.rmsnorm_init(cfg.d_model, dtype=dtype, device=device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: str | torch.device | None = None) -> Params:
    """Random parameters in the reference's tree, shapes and dtypes, drawn
    from ``gen`` (which lies on ``device``; default CUDA, raises without a
    GPU).  The draws are not the reference's: carry its weights across
    with ``convert.lm_params_from_numpy``.  Blocks are drawn one at a time
    into the stacked leaves, so the peak is one block above the weights."""
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = _dt(cfg)
    nb = cfg.num_blocks
    layers = {}
    for pos, (mixer, fkind) in enumerate(cfg.block_program()):
        stacked = None
        for b in range(nb):
            one = _block_position_init(gen, cfg, mixer, fkind, dtype, device)
            if stacked is None:
                stacked = _tree_map(
                    lambda a: torch.empty((nb, *a.shape), dtype=a.dtype,
                                          device=a.device), one)
            _tree_zip(lambda s, a, b=b: s[b].copy_(a), stacked, one)
        layers[f"pos{pos}"] = stacked
    params: Params = {
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype=dtype,
                                   device=device),
        "layers": layers,
        "final_norm": nn.rmsnorm_init(cfg.d_model, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                           dtype=dtype, device=device)
    return params


# ===========================================================================
# Block forward (full sequence)
# ===========================================================================
def _run_attn(p: Params, x, cfg: ModelConfig, positions):
    """Causal self-attention (the reference's bidirectional and cross
    variants serve the encoder, ROADMAP A9)."""
    B, S, d = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = nn.linear(p["wq"], x).reshape(B, S, h, hd)
    k = nn.linear(p["wk"], x).reshape(B, S, hkv, hd)
    v = nn.linear(p["wv"], x).reshape(B, S, hkv, hd)
    q = nn.apply_rope(q, positions, cfg.rope_theta)
    k = nn.apply_rope(k, positions, cfg.rope_theta)
    o = attn.flash_attention(q, k, v, causal=True)
    return nn.linear(p["wo"], o.reshape(B, S, h * hd))


def _run_ffn(p: Params, x, cfg: ModelConfig, kind: str):
    """The position's FFN output.  Serving reads no aux loss, so the MoE's
    is not computed (``ffn.moe_aux`` gives it to training, ROADMAP A10)."""
    if kind == "moe":
        r = ffn_lib.moe_route(p, x, experts_per_token=cfg.experts_per_token,
                              capacity_factor=cfg.capacity_factor)
        return ffn_lib.moe_apply(p, x, r)
    return ffn_lib.dense_ffn(p, x)


def _position_forward(cfg: ModelConfig, p: Params, mixer: str, fkind: str, x,
                      positions):
    """One sub-layer position within a block."""
    if mixer == "rwkv":
        x = x + ssm.rwkv6_time_mix(
            p["mixer"], nn.rmsnorm(p["norm1"], x, cfg.norm_eps),
            head_size=cfg.rwkv_head_size)
        return x + ssm.rwkv6_channel_mix(
            p["mixer"], nn.rmsnorm(p["norm2"], x, cfg.norm_eps))
    if cfg.parallel_block:
        hshared = nn.rmsnorm(p["norm1"], x, cfg.norm_eps)
        a = _run_attn(p["mixer"], hshared, cfg, positions)
        return x + a + _run_ffn(p["ffn"], hshared, cfg, fkind)
    h = nn.rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + _run_attn(p["mixer"], h, cfg, positions)
    return x + _run_ffn(p["ffn"], nn.rmsnorm(p["norm2"], x, cfg.norm_eps), cfg,
                        fkind)


# ===========================================================================
# Inference prefill: forward-only, emits the K/V taps + last-token logits
# ===========================================================================
def _head_table_T(cfg: ModelConfig, params: Params):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Batch):
    """Returns (x [B,S,d], positions [1,S]).  The reference also returns the
    targets and loss mask, which only training reads (ROADMAP A10); there
    is no modality frontend (ROADMAP A9)."""
    tokens = batch["tokens"]
    x = nn.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    return x, positions


def prefill_forward(cfg: ModelConfig):
    """Returns fn(params, batch) -> (last_logits [B,V] float32, kv_outputs).

    kv_outputs: per attention position, the post-RoPE K/V of the whole
    prompt stacked over blocks ``[nb, B, S, hkv, hd]``; nothing for the
    RWKV positions, as in the reference."""
    _check_supported(cfg)

    @torch.no_grad()
    def fn(params: Params, batch: Batch):
        x, positions = _embed_inputs(cfg, params, batch)
        B, S, _ = x.shape
        hkv, hd = cfg.num_kv_heads, cfg.head_dim
        taps: dict = {}
        for b in range(cfg.num_blocks):
            block_params = _block(params["layers"], b)
            for pos, (mixer, fkind) in enumerate(cfg.block_program()):
                p = block_params[f"pos{pos}"]
                if mixer == "attn":
                    # tap the post-RoPE K/V of this layer for the cache
                    # output, re-projected as the reference does
                    hh = nn.rmsnorm(p["norm1"], x, cfg.norm_eps)
                    k = nn.linear(p["mixer"]["wk"], hh).reshape(B, S, hkv, hd)
                    v = nn.linear(p["mixer"]["wv"], hh).reshape(B, S, hkv, hd)
                    k = nn.apply_rope(k, positions, cfg.rope_theta)
                    tap = taps.setdefault(f"pos{pos}", {"k": [], "v": []})
                    tap["k"].append(k)
                    tap["v"].append(v)
                x = _position_forward(cfg, p, mixer, fkind, x, positions)
        kv = {name: {kk: torch.stack(vs) for kk, vs in tap.items()}
              for name, tap in taps.items()}
        x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = (x[:, -1] @ _head_table_T(cfg, params)).float()
        return logits, kv

    return fn


# ===========================================================================
# Serving: cache init + single-token decode step
# ===========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device | None = None) -> dict:
    """Decode state, stacked over blocks per position, on ``device``
    (default CUDA).  ``len`` is a host integer: the step reads it to index
    the cache without a device round trip."""
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = _dt(cfg)
    nb = cfg.num_blocks
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cache: dict = {"len": 0}
    for pos, (mixer, _) in enumerate(cfg.block_program()):
        if mixer == "attn":
            c = {"k": torch.zeros(nb, batch, max_seq, hkv, hd, dtype=dtype, device=device),
                 "v": torch.zeros(nb, batch, max_seq, hkv, hd, dtype=dtype, device=device)}
        else:  # rwkv
            H, hs = cfg.rwkv_heads, cfg.rwkv_head_size
            c = {"S": torch.zeros(nb, batch, H, hs, hs, dtype=torch.float32, device=device),
                 "x_tm": torch.zeros(nb, batch, cfg.d_model, dtype=dtype, device=device),
                 "x_cm": torch.zeros(nb, batch, cfg.d_model, dtype=dtype, device=device)}
        cache[f"pos{pos}"] = c
    return cache


def _decode_attn(p: Params, x_t, cfg: ModelConfig, kc, vc, t: int):
    """x_t: [B,1,d]; kc/vc: [B,Smax,hkv,hd], row t written in place; t:
    the position.  Returns the attention output [B,1,d]."""
    B = x_t.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x_t.device)
    q = nn.apply_rope(nn.linear(p["wq"], x_t).reshape(B, 1, h, hd), pos, cfg.rope_theta)
    k = nn.apply_rope(nn.linear(p["wk"], x_t).reshape(B, 1, hkv, hd), pos, cfg.rope_theta)
    v = nn.linear(p["wv"], x_t).reshape(B, 1, hkv, hd)
    attn.update_kv_cache(kc, vc, k, v, t)
    o = attn.decode_attention(q, kc, vc, t + 1)
    return nn.linear(p["wo"], o.reshape(B, 1, h * hd))


def serve_step(cfg: ModelConfig):
    """Returns step_fn(params, cache, tokens [B,1]) -> (logits [B,V] float32,
    cache).

    Unlike the reference, the step updates ``cache`` in place (the K/V
    rows at position ``len``, the RWKV states, ``len`` itself) and returns
    it: the caller passes each cache once."""
    _check_supported(cfg)

    @torch.no_grad()
    def step_fn(params: Params, cache: dict, tokens: torch.Tensor):
        t = cache["len"]
        x = nn.embed(params["embed"], tokens)          # [B,1,d]
        for b in range(cfg.num_blocks):
            block_params = _block(params["layers"], b)
            for pos, (mixer, fkind) in enumerate(cfg.block_program()):
                p = block_params[f"pos{pos}"]
                c = cache[f"pos{pos}"]
                if mixer == "rwkv":
                    h = nn.rmsnorm(p["norm1"], x, cfg.norm_eps)
                    y, tm_cache = ssm.rwkv6_time_mix_step(
                        p["mixer"], h, {"S": c["S"][b], "x_tm": c["x_tm"][b],
                                        "x_cm": c["x_cm"][b]},
                        head_size=cfg.rwkv_head_size)
                    x = x + y
                    h2 = nn.rmsnorm(p["norm2"], x, cfg.norm_eps)
                    y2, cm_cache = ssm.rwkv6_channel_mix_step(p["mixer"], h2, tm_cache)
                    x = x + y2
                    for name in ("S", "x_tm", "x_cm"):
                        c[name][b].copy_(cm_cache[name])
                    continue
                if t >= c["k"].shape[2]:
                    raise ValueError(f"the cache holds {c['k'].shape[2]} positions; "
                                     f"position {t} does not fit")
                h = nn.rmsnorm(p["norm1"], x, cfg.norm_eps)
                a = _decode_attn(p["mixer"], h, cfg, c["k"][b], c["v"][b], t)
                if cfg.parallel_block:
                    x = x + a + _run_ffn(p["ffn"], h, cfg, fkind)
                    continue
                x = x + a
                x = x + _run_ffn(p["ffn"], nn.rmsnorm(p["norm2"], x, cfg.norm_eps),
                                 cfg, fkind)
        cache["len"] = t + 1
        x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = (x[:, 0] @ _head_table_T(cfg, params)).float()
        return logits, cache

    return step_fn
