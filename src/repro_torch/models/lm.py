"""Language models: parameters, training loss and serving (``repro/models/lm.py``).

One parameter layout, the training loss and the serving entry points:

  init_params(cfg, gen, device)              -> parameter dict
  train_loss(cfg)(params, batch)             -> (loss, {"ce", "aux"})
  prefill_forward(cfg)(params, batch)        -> (last logits, K/V taps)
  encode(cfg, params, frames)                -> encoder memory   [encdec]
  init_cache(cfg, batch, max_seq, device, enc_len=0) -> decode state
  prefill_encoder(cfg, params, cache, frames) -> cache with the memory's K/V
  serve_step(cfg)(params, cache, tokens)     -> (logits, cache)

All six families of the reference are ported: ``dense`` (GQA transformer,
with the parallel block), ``moe`` (the routed top-k FFN of
``ffn.moe_ffn``, shared experts included), ``ssm`` (RWKV6 Finch),
``hybrid`` (Jamba: Mamba layers between the attention ones, MoE every
other layer), ``vlm`` (a patch-embedding frontend stub: precomputed
embeddings ``batch["frontend_embeds"]`` in front of the tokens) and
``encdec`` (seamless-m4t: a bidirectional encoder over precomputed frame
embeddings, and cross-attention in every decoder layer).  Training adds
the MoE's auxiliary loss (``ffn.moe_ffn``); serving does not compute it,
as the reference's serving discards it.  Parameters keep the reference's
tree: per-position leaves stacked over the ``num_blocks`` identical
blocks ``[nb, ...]``, run here by a Python loop over the blocks; in
training (grad mode) with ``cfg.remat`` each block, and each encoder
layer, runs under ``torch.utils.checkpoint``, as the reference
rematerializes them.  Attention goes through the flash-attention kernel
(cross-attention at the memory's own length, over every row of it) and
the RWKV6 recurrence through the WKV6 kernel, their gradients through
the kernels' ``autograd.Function``s (flash's backward a kernel too,
WKV6's a plain recompute); everything else
is plain PyTorch, as the reference left it to XLA.  The reference's
activation-sharding hints (``sharding.ctx.constrain``) sit at its points:
no-ops without a mesh, so every single-device number is unchanged.

Over a mesh (the meshed train step, the dry-run's prefill and the
tensor-parallel decode) ``train_loss``, ``prefill_forward`` and
``serve_step`` take the placed tree, each rank holding its shards
(``policy.params_sharding``), and gather as the reference's rematerialized
scan does: the leaves outside the blocks once, each block's just before it
runs and, in training, again in its recompute
(``sharding/gather.py``: ``gather_outside_blocks``, ``BlockShards``).  A
block's parameters are then DTensors on the ``model`` sub-mesh, and the
blocks are tensor-parallel (``docs/torch_lm_sharding.md``; a tree already
on that sub-mesh runs so too): each branch's input is ``ctx.tp_input``,
its row-parallel output is made whole where it joins the residual, the
cross-entropy is vocab-parallel where the vocab is cut
(``vocab_parallel_ce``), the MoE FFN is cut by experts or by each expert's
d_ff (``ffn.moe_apply``) and the Mamba mixer by ``d_inner``
(``ssm.mamba_forward``).  The decode step takes the cache cut over the axis
(``trainer.cache_model_shards``) and updates each rank's shard in place
(``serve_step``), the Mamba state's too."""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import nn, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx, gather

Params = dict
Batch = dict


def _dt(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


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


def _blocks(layers: Params, n: int) -> list[Params]:
    """The ``n`` blocks' parameters, views into the stacked leaves taken by
    one ``unbind`` a leaf, so a backward stacks each leaf's gradient once
    (``_block``'s select would scatter into a zero leaf a block)."""
    split = _tree_map(lambda a: a.unbind(0), layers)
    return [_tree_map(lambda parts, b=b: parts[b], split) for b in range(n)]


def _block_params(layers: Params, n: int, root: str = "layers") -> tuple[list, Callable]:
    """(what each of the ``n`` blocks is handed, the function that makes it
    the block's parameters).  Plain or model-axis leaves: the blocks' views
    (``_blocks``) and the identity.  A placed tree (``gather.is_placed``):
    each block's stored shards and ``gather.BlockShards.gather``, which the
    caller runs just before the block (inside its checkpoint in training),
    so one block's gathered leaves are live at a time."""
    if not gather.is_placed(layers):
        return _blocks(layers, n), _as_is
    shards = gather.BlockShards(layers, root)
    return [shards.shards(b) for b in range(n)], shards.gather


def _as_is(p: Params) -> Params:
    return p


def _outside_blocks(params: Params) -> Params:
    """A placed tree's leaves outside the blocks gathered once
    (``gather.gather_outside_blocks``); any other tree as it is."""
    return gather.gather_outside_blocks(params) if gather.is_placed(params) else params


def _recompute(fn: Callable, *args, remat: bool = True):
    """``fn(*args)``; under ``torch.utils.checkpoint`` when ``remat`` and
    autograd records, so the backward keeps only the arguments and
    recomputes the rest (nothing in ``fn`` draws at random)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


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
                         device, cross: bool = False) -> Params:
    p: Params = {"norm1": nn.rmsnorm_init(cfg.d_model, dtype=dtype, device=device)}
    if mixer == "rwkv":
        # RWKV folds its FFN (channel-mix) into the mixer params
        p["mixer"] = ssm.rwkv6_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.rwkv_head_size, dtype=dtype, device=device)
    else:
        if mixer == "mamba":
            p["mixer"] = ssm.mamba_init(gen, cfg.d_model, cfg.mamba_d_inner,
                                        cfg.mamba_d_state, cfg.mamba_d_conv,
                                        dtype=dtype, device=device)
        else:
            p["mixer"] = _attn_init(gen, cfg, dtype, device)
        p["ffn"] = _ffn_init(gen, cfg, fkind, dtype, device)
    p["norm2"] = nn.rmsnorm_init(cfg.d_model, dtype=dtype, device=device)
    if cross:
        p["norm_cross"] = nn.rmsnorm_init(cfg.d_model, dtype=dtype, device=device)
        p["cross"] = _attn_init(gen, cfg, dtype, device)
    return p


def _stacked(n: int, make: Callable[[], Params]) -> Params:
    """``n`` draws of ``make()`` stacked leaf by leaf ``[n, ...]``, drawn one
    at a time, so the peak is one draw above the stack (a single draw is
    not copied)."""
    if n == 1:
        return _tree_map(lambda a: a[None], make())
    stacked = None
    for b in range(n):
        one = make()
        if stacked is None:
            stacked = _tree_map(
                lambda a: torch.empty((n, *a.shape), dtype=a.dtype, device=a.device),
                one)
        _tree_zip(lambda s, a, b=b: s[b].copy_(a), stacked, one)
    return stacked


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: str | torch.device | None = None) -> Params:
    """Random parameters in the reference's tree, shapes and dtypes, drawn
    from ``gen`` (which lies on ``device``; default CUDA, raises without a
    GPU).  The draws are not the reference's: carry its weights across
    with ``convert.lm_params_from_numpy``.  Blocks are drawn one at a time
    into the stacked leaves, so the peak is one block above the weights."""
    device = resolve_device(device)
    dtype = _dt(cfg)
    cross = cfg.encoder_layers > 0
    layers = {
        f"pos{pos}": _stacked(cfg.num_blocks, lambda m=mixer, f=fkind: _block_position_init(
            gen, cfg, m, f, dtype, device, cross))
        for pos, (mixer, fkind) in enumerate(cfg.block_program())}
    params: Params = {
        "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype=dtype,
                                   device=device),
        "layers": layers,
        "final_norm": nn.rmsnorm_init(cfg.d_model, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                           dtype=dtype, device=device)
    if cfg.encoder_layers:
        params["enc_layers"] = _stacked(cfg.encoder_layers, lambda: _block_position_init(
            gen, cfg, "attn", "dense", dtype, device))
        params["enc_final_norm"] = nn.rmsnorm_init(cfg.d_model, dtype=dtype,
                                                   device=device)
    return params


# ===========================================================================
# Block forward (full sequence)
# ===========================================================================
def _run_attn(p: Params, x, cfg: ModelConfig, positions, causal: bool = True,
              memory=None):
    """Self-attention with rope, causal or bidirectional (the encoder); with
    ``memory`` ``[B, S_enc, d]``, cross-attention: keys and values from the
    memory, no rope, non-causal over every memory row, through the kernel
    at the memory's own length (the reference's pure-JAX twin reads only
    its first S rows, ROADMAP C10).

    On DTensors (tensor-parallel over the model axis) the projections are
    column-parallel and ``wo`` row-parallel, its output ``Partial``.  Heads
    the axis divides are cut over it; where q's do not (yi-34b's 56, granite's
    24 at 16), the reference shards head_dim and lets GSPMD complete a
    partial-sum attention, which the kernel cannot take: q, k, v are made
    whole instead and the attention core is repeated on the axis."""
    B, S, d = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if memory is None else memory
    q = nn.split_heads(nn.linear(p["wq"], x), h, hd)
    k = nn.split_heads(nn.linear(p["wk"], src), hkv, hd)
    v = nn.split_heads(nn.linear(p["wv"], src), hkv, hd)
    tp = max(ctx.axis_size("tp"), 1)
    head_par = cfg.num_heads % tp == 0
    use_seqpar = (not head_par and cfg.seqpar_attention and S % tp == 0
                  and memory is None)
    if head_par:
        q, k, v = (ctx.constrain(t, "dp", None, "tp", None) for t in (q, k, v))
    elif not use_seqpar and not isinstance(q, DTensor):
        # unsplittable head counts: shard head_dim (partial-sum attention)
        q, k, v = (ctx.constrain(t, "dp", None, None, "tp") for t in (q, k, v))
    if memory is None:
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
    if use_seqpar:
        # heads unsplittable (yi 56H, granite 24H): the q rows over the
        # model axis instead (sequence-parallel attention)
        o = attn.flash_attention_seqpar(q, k, v, causal=causal)
    else:
        o = attn.flash_attention(q, k, v, causal=causal and memory is None)
    return nn.linear(p["wo"], nn.merge_heads(o))


def _run_ffn(p: Params, x, cfg: ModelConfig, kind: str):
    """The position's FFN output in serving.  Serving reads no aux loss, so
    the MoE's is not computed (``_train_ffn`` gives it to training)."""
    if kind == "moe":
        r = ffn_lib.moe_route(p, x, experts_per_token=cfg.experts_per_token,
                              capacity_factor=cfg.capacity_factor)
        return ffn_lib.moe_apply(p, x, r)
    return ffn_lib.dense_ffn(p, x)


def _train_ffn(p: Params, x, cfg: ModelConfig, kind: str):
    """(the position's FFN output, the MoE's aux loss or None) in training:
    ``ffn.moe_ffn`` returns the Switch aux loss, as the reference's
    ``_run_ffn`` does.  A dense FFN has none."""
    if kind == "moe":
        return ffn_lib.moe_ffn(p, x, experts_per_token=cfg.experts_per_token,
                               capacity_factor=cfg.capacity_factor,
                               router_aux_coef=cfg.router_aux_coef)
    return ffn_lib.dense_ffn(p, x), None


def _ffn(p: Params, x, cfg: ModelConfig, kind: str, train: bool):
    return _train_ffn(p, x, cfg, kind) if train else (_run_ffn(p, x, cfg, kind), None)


def _whole(t):
    """A sub-layer's output made whole on the model axis before it joins the
    residual (the all-reduce of a row-parallel ``Partial``); a no-op on
    plain tensors."""
    return ctx.constrain(t, "dp", None, None)


def _position_forward(cfg: ModelConfig, p: Params, mixer: str, fkind: str, x,
                      positions, memory=None, train: bool = False):
    """One sub-layer position within a block; with ``memory``, the
    position's cross-attention after its mixer.  Returns (x, the MoE's aux
    loss or None; ``train`` computes it)."""
    def norm(name, x):      # a branch's input (its gradient made whole)
        return ctx.tp_input(nn.rmsnorm(p[name], x, cfg.norm_eps))

    if mixer == "rwkv":
        x = x + _whole(ssm.rwkv6_time_mix(p["mixer"], norm("norm1", x),
                                          head_size=cfg.rwkv_head_size))
        return x + _whole(ssm.rwkv6_channel_mix(p["mixer"], norm("norm2", x))), None
    if cfg.parallel_block and mixer == "attn":
        hshared = norm("norm1", x)
        a = _run_attn(p["mixer"], hshared, cfg, positions)
        f, aux = _ffn(p["ffn"], hshared, cfg, fkind, train)
        return x + _whole(a) + _whole(f), aux
    h = norm("norm1", x)
    if mixer == "attn":
        x = x + _whole(_run_attn(p["mixer"], h, cfg, positions))
    else:  # mamba
        x = x + _whole(ssm.mamba_forward(p["mixer"], h, d_state=cfg.mamba_d_state,
                                         d_conv=cfg.mamba_d_conv))
    if "cross" in p and memory is not None:
        x = x + _whole(_run_attn(p["cross"], norm("norm_cross", x), cfg, positions,
                                 memory=memory))
    f, aux = _ffn(p["ffn"], norm("norm2", x), cfg, fkind, train)
    return x + _whole(f), aux


def _block_forward(cfg: ModelConfig, block_params: Params, x, positions,
                   memory=None, make=_as_is):
    """One block (``cfg.block_period`` sub-layers) in training, its
    parameters ``make(block_params)`` (``_block_params``).  Returns (x, the
    block's aux loss, a float32 scalar)."""
    block_params = make(block_params)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for pos, (mixer, fkind) in enumerate(cfg.block_program()):
        x, aux = _position_forward(cfg, block_params[f"pos{pos}"], mixer, fkind, x,
                                   positions, memory, train=True)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def _scan_blocks(cfg: ModelConfig, layers: Params, x, positions, memory=None):
    """Every block in turn, each rematerialized under ``cfg.remat``.
    Returns (x, the summed aux loss)."""
    res_spec = ("dp", "tp", None) if cfg.seq_sharded_residual else ("dp", None, None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks, make = _block_params(layers, cfg.num_blocks)
    for block_params in blocks:
        x = ctx.constrain(x, *res_spec)
        x, aux_b = _recompute(_block_forward, cfg, block_params, x, positions, memory, make,
                              remat=cfg.remat)
        x = ctx.constrain(x, *res_spec)
        aux = aux + aux_b
    return x, aux


# ===========================================================================
# Encoder (enc-dec family)
# ===========================================================================
def _encoder_layer(cfg: ModelConfig, p: Params, x, positions, make=_as_is):
    p = make(p)
    h = ctx.tp_input(nn.rmsnorm(p["norm1"], x, cfg.norm_eps))
    x = x + _whole(_run_attn(p["mixer"], h, cfg, positions, causal=False))
    h = ctx.tp_input(nn.rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x + _whole(ffn_lib.dense_ffn(p["ffn"], h))


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames ``[B, S_src, d_model]``: precomputed frontend embeddings (the
    reference's stub) → the memory ``[B, S_src, d_model]``.  Each encoder
    layer is bidirectional self-attention with rope, then a dense FFN;
    differentiable, each layer rematerialized in training under
    ``cfg.remat`` (serving calls it under ``no_grad``)."""
    S = frames.shape[1]
    positions = torch.arange(S, device=frames.device)[None, :]
    params = _outside_blocks(params)
    x = ctx.enter(frames.to(_dt(cfg)), params["enc_final_norm"]["scale"])
    layers, make = _block_params(params["enc_layers"], cfg.encoder_layers, "enc_layers")
    for p in layers:
        x = _recompute(_encoder_layer, cfg, p, x, positions, make, remat=cfg.remat)
    return ctx.tp_input(nn.rmsnorm(params["enc_final_norm"], x, cfg.norm_eps))


# ===========================================================================
# Inference prefill: forward-only, emits the K/V taps + last-token logits
# ===========================================================================
def _head_table_T(cfg: ModelConfig, params: Params):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Batch):
    """Returns (x [B,P+S,d], targets [B,P+S], mask [B,P+S] float32,
    positions [1,P+S]): a vlm's frontend embeddings
    ``batch["frontend_embeds"]`` ``[B, P, d]``, where given, in front of the
    S token embeddings, their positions at target 0 and mask 0.  The mask
    defaults to ones.  Serving's batches carry no ``targets``: then targets
    and mask are None."""
    tokens = batch["tokens"]
    x = nn.embed(params["embed"], tokens)
    targets, mask = batch.get("targets"), None
    if targets is not None:
        mask = batch.get("mask")
        mask = (torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
                if mask is None else mask.float())
    if cfg.frontend is not None and "frontend_embeds" in batch:
        fe = ctx.enter(batch["frontend_embeds"].to(x.dtype), x)
        x = torch.cat([fe, x], dim=1)
        if targets is not None:
            pad = (tokens.shape[0], fe.shape[1])
            targets = torch.cat([targets.new_zeros(pad), targets], dim=1)
            mask = torch.cat([mask.new_zeros(pad), mask], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return ctx.constrain(x, "dp", None, None), targets, mask, positions


# ===========================================================================
# Training loss
# ===========================================================================
def _chunk_loss(xc, table_T, tc, mc):
    logits = ctx.constrain((xc @ table_T).float(), "dp", None, "tp")
    if isinstance(logits, DTensor):
        if logits.placements[0].is_shard() and logits.device_mesh.size() > 1:
            return (vocab_parallel_ce(logits, tc) * mc).sum(), mc.sum()
        logits = ctx.local(logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


class _VocabParallelCE(torch.autograd.Function):
    """Per-token ``logsumexp(logits) − logits[target]`` over logits whose
    vocab is cut over a process group, each rank holding ``[..., V/n]``
    columns from ``lo``: the local max then an all-reduce of the max, the
    local sum of exp then an all-reduce of the sum, the gold logit where the
    target falls in the rank's range then an all-reduce of the sum.  Every
    rank returns the same losses.  Backward: each rank's columns of
    ``(softmax − onehot(target)) · g``, no collective."""

    @staticmethod
    def forward(ctx_, logits, targets, group, lo: int):
        import torch.distributed as dist
        n = logits.shape[-1]
        m = logits.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        s = torch.exp(logits - m[..., None]).sum(-1)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        lse = m + torch.log(s)
        t = targets.long() - lo
        inside = (t >= 0) & (t < n)
        t = t.clamp(0, n - 1)
        gold = torch.where(inside, torch.gather(logits, -1, t[..., None])[..., 0], 0.0)
        dist.all_reduce(gold, op=dist.ReduceOp.SUM, group=group)
        ctx_.save_for_backward(logits, lse, t, inside)
        return lse - gold

    @staticmethod
    def backward(ctx_, g):
        logits, lse, t, inside = ctx_.saved_tensors
        grad = torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, t[..., None], -inside[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def vocab_parallel_ce(logits: DTensor, targets: torch.Tensor) -> torch.Tensor:
    """The per-token cross-entropy ``[...]`` (a plain tensor, the same on
    every rank) of float32 logits ``[..., V]`` cut over the vocab (a DTensor
    ``Shard(-1)`` on the model axis) against ``targets``: the vocab-parallel
    form of ``logsumexp(logits) − gather(logits, targets)``, which is its
    plain twin (``_chunk_loss``)."""
    local = logits.to_local()
    lo = logits.device_mesh.get_local_rank() * local.shape[-1]
    return _VocabParallelCE.apply(local, targets, logits.device_mesh.get_group(), lo)


def chunked_cross_entropy(x, table_T, targets, mask, chunk: int = 512):
    """Mean per-token cross-entropy against a ``[d, V]`` head without
    materializing ``[B, S, V]``: x ``[B, S, d]`` final hidden, targets and
    mask ``[B, S]``.  Chunks of ``chunk`` positions, each rematerialized in
    the backward; the last chunk takes what is left, so every token counts
    (the reference's ``S // (S // chunk)`` chunks drop a tail of S mod
    that size, ROADMAP C11).  When the batch's rows are cut over the data
    axes, the sum and the count are the global batch's (``ctx.batch_sum``)."""
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, x.shape[1], chunk):
        sl = slice(s0, s0 + chunk)
        l, c = _recompute(_chunk_loss, x[:, sl], table_T, targets[:, sl], mask[:, sl])
        tot, cnt = tot + l, cnt + c
    tot, cnt = ctx.batch_sum(tot), ctx.batch_sum(cnt)
    return tot / torch.clamp(cnt, min=1.0)


def train_loss(cfg: ModelConfig):
    """Returns loss_fn(params, batch) -> (loss, {"ce", "aux"}), float32
    scalars: the cross-entropy over ``batch["targets"]`` (weighted by
    ``batch["mask"]``, default ones) plus the MoE's aux loss.  ``batch``
    holds ``tokens`` and ``targets`` ``[B, S]``, and a vlm's
    ``frontend_embeds`` or an encdec's ``frames`` as serving's do.
    Cross-attention reads every memory row (the reference's reads only the
    first S, ROADMAP C10)."""

    def loss_fn(params: Params, batch: Batch):
        params = _outside_blocks(params)
        memory = encode(cfg, params, batch["frames"]) if cfg.encoder_layers else None
        x, targets, mask, positions = _embed_inputs(cfg, params, batch)
        x, aux = _scan_blocks(cfg, params["layers"], x, positions, memory)
        if cfg.seq_sharded_residual:
            # gather the final activation for the vocab projection
            x = ctx.constrain(x, "dp", None, None)
        x = ctx.tp_input(nn.rmsnorm(params["final_norm"], x, cfg.norm_eps))
        ce = chunked_cross_entropy(x, _head_table_T(cfg, params), targets, mask)
        return ce + aux, {"ce": ce, "aux": aux}

    return loss_fn


def _prefill_block(cfg: ModelConfig, block_params: Params, x, positions, memory,
                   taps: dict):
    """One block of the prefill: ``x`` after it; each attention position's
    post-RoPE K/V appended to ``taps``, re-projected as the reference does."""
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    for pos, (mixer, fkind) in enumerate(cfg.block_program()):
        p = block_params[f"pos{pos}"]
        if mixer == "attn":
            hh = nn.rmsnorm(p["norm1"], x, cfg.norm_eps)
            k = ctx.local(nn.split_heads(nn.linear(p["mixer"]["wk"], hh), hkv, hd))
            v = ctx.local(nn.split_heads(nn.linear(p["mixer"]["wv"], hh), hkv, hd))
            k = nn.apply_rope(k, positions, cfg.rope_theta)
            tap = taps.setdefault(f"pos{pos}", {"k": [], "v": []})
            tap["k"].append(k)
            tap["v"].append(v)
        x, _ = _position_forward(cfg, p, mixer, fkind, x, positions, memory)
    return x


def prefill_forward(cfg: ModelConfig):
    """Returns fn(params, batch) -> (last_logits [B,V] float32, kv_outputs).

    kv_outputs: per attention position, the post-RoPE K/V of the whole
    prompt (frontend positions included) stacked over blocks ``[nb, B, S,
    hkv, hd]``; nothing for the RWKV and Mamba positions, as in the
    reference.  An encdec config reads ``batch["frames"]`` ``[B, S_enc,
    d]`` and attends to the whole encoded memory."""

    @torch.no_grad()
    def fn(params: Params, batch: Batch):
        params = _outside_blocks(params)
        memory = encode(cfg, params, batch["frames"]) if cfg.encoder_layers else None
        x, _, _, positions = _embed_inputs(cfg, params, batch)
        taps: dict = {}
        blocks, make = _block_params(params["layers"], cfg.num_blocks)
        for b in range(cfg.num_blocks):
            # the block's gathered leaves live for this call alone
            x = _prefill_block(cfg, make(blocks[b]), x, positions, memory, taps)
        kv = {name: {kk: torch.stack(vs) for kk, vs in tap.items()}
              for name, tap in taps.items()}
        x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = ctx.local((x[:, -1] @ _head_table_T(cfg, params)).float())
        return logits, kv

    return fn


# ===========================================================================
# Serving: cache init + single-token decode step
# ===========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device | None = None, enc_len: int = 0) -> dict:
    """Decode state, stacked over blocks per position, on ``device``
    (default CUDA).  ``len`` is a host integer: the step reads it to index
    the cache without a device round trip.  An encdec config's positions
    also hold ``enc_len`` rows of cross-attention K/V (``ck``, ``cv``),
    zeros until ``prefill_encoder`` writes the memory's."""
    device = resolve_device(device)
    dtype = _dt(cfg)
    nb = cfg.num_blocks
    hkv, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(nb, batch, *shape, dtype=dt, device=device)

    cache: dict = {"len": 0}
    for pos, (mixer, _) in enumerate(cfg.block_program()):
        if mixer == "attn":
            c = {"k": zeros(max_seq, hkv, hd), "v": zeros(max_seq, hkv, hd)}
        elif mixer == "mamba":
            c = {"h": zeros(cfg.mamba_d_inner, cfg.mamba_d_state, dt=torch.float32),
                 "conv": zeros(cfg.mamba_d_conv - 1, cfg.mamba_d_inner)}
        else:  # rwkv
            H, hs = cfg.rwkv_heads, cfg.rwkv_head_size
            c = {"S": zeros(H, hs, hs, dt=torch.float32),
                 "x_tm": zeros(cfg.d_model), "x_cm": zeros(cfg.d_model)}
        if cfg.encoder_layers:
            c["ck"] = zeros(enc_len, hkv, hd)
            c["cv"] = zeros(enc_len, hkv, hd)
        cache[f"pos{pos}"] = c
    return cache


def _decode_attn(p: Params, x_t, cfg: ModelConfig, kc, vc, t: int):
    """x_t: [B,1,d]; kc/vc: [B,Smax,hkv,hd], row t written in place; t:
    the position.  Returns the attention output [B,1,d] (on DTensors the
    row-parallel ``wo``'s ``Partial``; the cache's route is
    ``attention.decode_attention``'s)."""
    B = x_t.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x_t.device)
    q = nn.apply_rope(nn.split_heads(nn.linear(p["wq"], x_t), h, hd), pos, cfg.rope_theta)
    k = nn.apply_rope(nn.split_heads(nn.linear(p["wk"], x_t), hkv, hd), pos, cfg.rope_theta)
    v = nn.split_heads(nn.linear(p["wv"], x_t), hkv, hd)
    attn.update_kv_cache(kc, vc, k, v, t)
    o = attn.decode_attention(q, kc, vc, t + 1)
    return nn.linear(p["wo"], nn.merge_heads(o))


def _decode_cross_attn(p: Params, x_t, cfg: ModelConfig, ck, cv, enc_len: int):
    """x_t ``[B,1,d]`` against the memory's K/V ``[B, enc_len, hkv, hd]``:
    no rope, every row."""
    q = nn.split_heads(nn.linear(p["wq"], x_t), cfg.num_heads, cfg.head_dim)
    o = attn.decode_attention(q, ck, cv, enc_len)
    return nn.linear(p["wo"], nn.merge_heads(o))


def _cache_block(leaf, b: int):
    """Block ``b`` of a stacked cache leaf, a view; of a DTensor leaf, the
    view of its local shard as a DTensor with the placement one dimension
    down."""
    if not isinstance(leaf, DTensor):
        return leaf[b]
    pl = leaf.placements[0]
    pl = Shard(pl.dim - 1) if isinstance(pl, Shard) else pl
    return DTensor.from_local(leaf.to_local()[b], leaf.device_mesh, [pl], run_check=False)


def _store(leaf, b: int, value) -> None:
    """Block ``b`` of a stacked cache leaf set to ``value`` in place; of a
    DTensor leaf, the rank's shard of ``value`` (plain or a DTensor, made
    the block's placement) written into its local tensor."""
    if not isinstance(leaf, DTensor):
        leaf[b].copy_(value)
        return
    block = _cache_block(leaf, b)
    value = ctx.enter(value, block).redistribute(block.device_mesh, block.placements)
    block.to_local().copy_(value.to_local())


def _serve_block(cfg: ModelConfig, block_params: Params, cache: dict, b: int, x, t: int):
    """Block ``b`` of a decode step at position ``t``: ``x`` after it, the
    block's rows of ``cache`` updated in place."""
    for pos, (mixer, fkind) in enumerate(cfg.block_program()):
        p = block_params[f"pos{pos}"]
        c = cache[f"pos{pos}"]
        if mixer == "rwkv":
            h = nn.rmsnorm(p["norm1"], x, cfg.norm_eps)
            y, tm_cache = ssm.rwkv6_time_mix_step(
                p["mixer"], h, {name: _cache_block(c[name], b)
                                for name in ("S", "x_tm", "x_cm")},
                head_size=cfg.rwkv_head_size)
            x = x + _whole(y)
            h2 = nn.rmsnorm(p["norm2"], x, cfg.norm_eps)
            y2, cm_cache = ssm.rwkv6_channel_mix_step(p["mixer"], h2, tm_cache)
            x = x + _whole(y2)
            for name in ("S", "x_tm", "x_cm"):
                _store(c[name], b, cm_cache[name])
            continue
        h = nn.rmsnorm(p["norm1"], x, cfg.norm_eps)
        if mixer == "attn":
            if t >= c["k"].shape[2]:
                raise ValueError(f"the cache holds {c['k'].shape[2]} positions; "
                                 f"position {t} does not fit")
            a = _decode_attn(p["mixer"], h, cfg, _cache_block(c["k"], b),
                             _cache_block(c["v"], b), t)
            if cfg.parallel_block:
                x = x + _whole(a) + _whole(_run_ffn(p["ffn"], h, cfg, fkind))
                continue
            x = x + _whole(a)
        else:  # mamba
            state = {name: _cache_block(c[name], b) for name in ("h", "conv")}
            y, mc = ssm.mamba_step(p["mixer"], h, state, d_state=cfg.mamba_d_state,
                                   d_conv=cfg.mamba_d_conv)
            x = x + _whole(y)
            _store(c["h"], b, mc["h"])
            _store(c["conv"], b, mc["conv"])
        if "cross" in p and "ck" in c:
            hc = nn.rmsnorm(p["norm_cross"], x, cfg.norm_eps)
            x = x + _whole(_decode_cross_attn(
                p["cross"], hc, cfg, _cache_block(c["ck"], b),
                _cache_block(c["cv"], b), c["ck"].shape[2]))
        x = x + _whole(_run_ffn(p["ffn"], nn.rmsnorm(p["norm2"], x, cfg.norm_eps),
                                cfg, fkind))
    return x


def serve_step(cfg: ModelConfig):
    """Returns step_fn(params, cache, tokens [B,1]) -> (logits [B,V] float32,
    cache).

    Unlike the reference, the step updates ``cache`` in place (the K/V
    rows at position ``len``, the RWKV and Mamba states, ``len`` itself)
    and returns it: the caller passes each cache once.  An encdec config
    reads the cross-attention K/V that ``prefill_encoder`` wrote (all
    ``enc_len`` rows; none with ``enc_len`` 0, which adds nothing).

    Tensor-parallel on the model axis (``docs/torch_lm_sharding.md``):
    under ``ctx.use_mesh(mesh)``, with the parameters placed by the policy
    (each block's gathered just before it runs, ``gather.BlockShards``),
    the cache from ``trainer.cache_model_shards`` (DTensors on
    ``mesh["model"]``) and ``tokens`` this rank's rows, the step computes
    on DTensor activations as the train step's blocks do, each rank
    updating its shard of the cache in place; the logits come back whole,
    ``[B_rank, V]``.  The MoE FFN is cut by experts or by d_ff, and the
    Mamba step runs on the rank's channels of its state, which the cache
    holds cut alike."""

    @torch.no_grad()
    def step_fn(params: Params, cache: dict, tokens: torch.Tensor):
        t = cache["len"]
        params = _outside_blocks(params)
        x = nn.embed(params["embed"], tokens)          # [B,1,d]
        blocks, make = _block_params(params["layers"], cfg.num_blocks)
        for b in range(cfg.num_blocks):
            # the block's gathered leaves live for this call alone
            x = _serve_block(cfg, make(blocks[b]), cache, b, x, t)
        cache["len"] = t + 1
        x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = ctx.local((x[:, 0] @ _head_table_T(cfg, params)).float())
        return logits, cache

    return step_fn


@torch.no_grad()
def prefill_encoder(cfg: ModelConfig, params: Params, cache: dict,
                    frames: torch.Tensor) -> dict:
    """Run the encoder over ``frames`` ``[B, S_enc, d]`` and put each decoder
    position's cross-attention K/V of the memory into the cache (``ck``,
    ``cv`` ``[nb, B, S_enc, hkv, hd]``, replacing the ``enc_len`` rows it
    was built with).  Returns the cache."""
    memory = encode(cfg, params, frames)
    B, Se, _ = memory.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    for pos in range(cfg.block_period):
        cross = params["layers"][f"pos{pos}"]["cross"]
        kv = {name: torch.stack([
            nn.linear(_block(cross[w], b), memory).reshape(B, Se, hkv, hd)
            for b in range(cfg.num_blocks)]) for name, w in (("ck", "wk"), ("cv", "wv"))}
        cache[f"pos{pos}"].update(kv)
    return cache
