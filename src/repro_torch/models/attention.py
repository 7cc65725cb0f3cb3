"""GQA attention (``repro/models/attention.py``): the full-sequence path
through the flash-attention kernel, and the cached decode step.

``flash_attention`` is where the reference calls its pure-JAX twin of the
Pallas kernel (same online softmax); here it goes through
``kernels/flash_attention``: the hand-written CUDA kernel on the card,
its plain version on the CPU; its gradient is ``FlashAttentionFn``'s
backward, the hand-written backward kernels on the card and their plain
version on the CPU.  The kernel tiles itself, so the
reference's ``q_chunk``/``kv_chunk`` have no counterpart, and it masks a
ragged S instead of asserting it away.  Non-causal attention takes keys
of their own length: the reference's twin cuts k/v into chunks by q's
length, so its cross-attention over a memory longer than q reads only
the first S rows (ROADMAP C10); here every row is read.  Decode attention is a plain
masked softmax over the cache, as in the reference.

On DTensor q, k, v (the meshed train step and the dry-run's prefill,
``sharding/ctx.py``) the kernel runs through ``local_map`` on each rank's
local heads: q cut by heads over the ``model`` axis, k and v cut alike
where their head count divides the axis.  Where it does not (llama3-8b's 8
kv heads at 16 ranks), k and v arrive whole, and each rank slices the kv
heads its q heads read, ``h // (H / Hkv)`` (the kv-slicing rule), so the
kernel's GQA check sees local counts; their gradient is then ``Partial``
over the axis, each rank's share.  Where q's heads do not divide the axis
(yi-34b's 56, granite's 24 at 16) the caller passes q, k, v whole and the
attention core is repeated on every rank of the axis.

``flash_attention_seqpar`` is the reference's sequence-parallel variant
for head counts the model axis does not divide: plain PyTorch in both
packages (no Pallas kernel), the online softmax over chunks of keys with
the q rows marked for the model axis (``ctx.constrain``).  The reference
visits ``S // kv_chunk`` chunks, so past S = 1024 it drops the keys beyond
the last full chunk; here every key is read (ROADMAP C13).

The decode step on a DTensor cache (the tensor-parallel ``lm.serve_step``,
the cache's leaves rewrapped on the ``model`` sub-mesh by
``trainer.cache_model_shards``) takes the route of the cache's placement,
which ``policy.cache_spec`` chose: cut by kv heads where the axis divides
them, each rank attends its q heads to its kv heads (``local_map``); cut
by positions where it divides ``Smax`` instead (the reference's
"flash-decoding style partial softmax"), q is made whole, each rank takes
a float32 partial ``(o, m, l)`` over its own rows and the partials are
combined over the axis (:func:`decode_attention_seqpar`); whole, the
attention is repeated on every rank.  ``update_kv_cache`` writes the new
row into the rank's own shard, on the rank that holds it."""
from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.sharding import ctx

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q ``[B, S, H, hd]``; k, v ``[B, Skv, Hkv, hd]`` (Skv = S when
    causal) → ``[B, S, H, hd]``.  DTensors run on each rank's local heads
    (the module docstring)."""
    if isinstance(q, DTensor):
        return _flash_local_heads(q, k, v, causal)
    return fa_ops.flash_attention(q, k, v, causal=causal)


def kv_heads_of(rank: int, heads: int, H: int, Hkv: int) -> slice:
    """The kv heads that q heads ``[rank·heads, (rank+1)·heads)`` read (head
    h reads ``h // (H / Hkv)``), a slice: they must form equal groups in
    order, so that the kernel's own GQA mapping holds on the local heads
    (every config's head counts on a model axis that divides H do)."""
    G = H // Hkv
    idx = [(rank * heads + h) // G for h in range(heads)]
    n = idx[-1] - idx[0] + 1
    if heads % n or any(i != idx[0] + h // (heads // n) for h, i in enumerate(idx)):
        raise ValueError(f"flash attention: q heads {idx[0]}.. of rank {rank} ({heads} of "
                         f"{H}) read kv heads {idx} of {Hkv}, not in equal groups")
    return slice(idx[0], idx[0] + n)


def _flash_local_heads(q, k, v, causal: bool):
    """The kernel on each rank's heads through ``local_map``: q ``Shard(2)``
    with k, v ``Shard(2)`` or whole (sliced to the rank's kv heads, their
    gradient ``Partial``), or all three whole (the core repeated)."""
    mesh = q.device_mesh
    cut = [Shard(2)]
    if q.placements[0] != Shard(2):
        q, k, v = (t.redistribute(mesh, [Replicate()]) for t in (q, k, v))
        return local_map(functools.partial(fa_ops.flash_attention, causal=causal),
                         out_placements=[Replicate()], device_mesh=mesh)(q, k, v)
    if k.placements[0] == Shard(2):
        return local_map(functools.partial(fa_ops.flash_attention, causal=causal),
                         out_placements=cut, in_placements=(cut, cut, cut),
                         device_mesh=mesh)(q, k, v)
    k, v = (t.redistribute(mesh, [Replicate()]) for t in (k, v))
    H, Hkv = q.shape[2], k.shape[2]
    heads = H // mesh.size()
    sel = kv_heads_of(mesh.get_local_rank(), heads, H, Hkv)

    def body(ql, kl, vl):
        return fa_ops.flash_attention(ql, kl[:, :, sel], vl[:, :, sel], causal=causal)
    whole = [Replicate()]
    return local_map(body, out_placements=cut, in_placements=(cut, whole, whole),
                     in_grad_placements=(cut, [Partial()], [Partial()]),
                     device_mesh=mesh)(q, k, v)


def _attend_chunk(q, k, v, mask, scale: float):
    """One (q tile × kv tile) online-softmax step: q ``[B, Tq, H, hd]``, k/v
    ``[B, Tk, Hkv, hd]``, mask ``[Tq, Tk]`` or None → the unnormalized
    float32 (o ``[B, Tq, Hkv, G, hd]``, m, l ``[B, Tq, Hkv, G]``)."""
    B, Tq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Tq, Hkv, H // Hkv, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return torch.einsum("bqkgs,bskd->bqkgd", p, v.float()), m, p.sum(dim=-1)


def _rescaled(o, m, l, m_new):
    """An online-softmax partial's ``o`` and ``l`` at the larger max
    ``m_new``: each times ``e^(m − m_new)``."""
    a = torch.exp(m - m_new)
    return o * a[..., None], l * a


def _merge(acc, new):
    """Merge two online-softmax partials."""
    o1, m1, l1 = acc
    o2, m2, l2 = new
    m = torch.maximum(m1, m2)
    o1, l1 = _rescaled(o1, m1, l1, m)
    o2, l2 = _rescaled(o2, m2, l2, m)
    return o1 + o2, m, l1 + l2


def flash_attention_seqpar(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True, kv_chunk: int = 1024) -> torch.Tensor:
    """Sequence-parallel attention: q ``[B, S, H, hd]`` rows marked for the
    model axis, k/v ``[B, S, Hkv, hd]`` whole (the ring-attention split of
    the work).  The reference takes this branch when the head count does not
    divide the model axis (yi-34b's 56 heads, granite's 24).  Every kv chunk
    is visited (no causal chunk skipping), the last one what is left."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    kv_chunk = min(kv_chunk, S)
    q = ctx.constrain(q, "dp", "tp", None, None)
    q_pos = torch.arange(S, device=q.device)

    def shard(o, m, l):
        return (ctx.constrain(o, "dp", "tp", None, None, None),
                ctx.constrain(m, "dp", "tp", None, None),
                ctx.constrain(l, "dp", "tp", None, None))

    acc = shard(torch.zeros(B, S, Hkv, G, hd, dtype=torch.float32, device=q.device),
                torch.full((B, S, Hkv, G), NEG_INF, dtype=torch.float32, device=q.device),
                torch.zeros(B, S, Hkv, G, dtype=torch.float32, device=q.device))
    for j0 in range(0, S, kv_chunk):
        kj, vj = k[:, j0:j0 + kv_chunk], v[:, j0:j0 + kv_chunk]
        mask = None
        if causal:
            mask = q_pos[:, None] >= torch.arange(j0, j0 + kj.shape[1],
                                                  device=q.device)[None, :]
        acc = shard(*_merge(acc, _attend_chunk(q, kj, vj, mask, scale)))
    o, _, l = acc
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.reshape(B, S, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """q ``[B, 1, H, hd]`` (one new token) against the first ``cache_len``
    positions of k/v_cache ``[B, Smax, Hkv, hd]``.  A DTensor cache takes
    the route of its placement (the module docstring)."""
    if isinstance(k_cache, DTensor):
        return _decode_cut(q, k_cache, v_cache, cache_len)
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


def _decode_cut(q, k_cache: DTensor, v_cache: DTensor, cache_len: int):
    """Decode attention on a cache cut over the model axis: by kv heads
    (``Shard(2)``; q cut alike, each rank's q heads read its own kv heads),
    by positions (``Shard(1)``, :func:`decode_attention_seqpar`) or whole
    (the attention repeated on every rank)."""
    mesh = k_cache.device_mesh
    if k_cache.placements[0] == Shard(2):
        cut = [Shard(2)]
        return local_map(functools.partial(decode_attention, cache_len=cache_len),
                         out_placements=cut, in_placements=(cut, cut, cut),
                         device_mesh=mesh)(q.redistribute(mesh, cut), k_cache, v_cache)
    if k_cache.placements[0] == Shard(1):
        return decode_attention_seqpar(q, k_cache, v_cache, cache_len)
    return ctx.enter(decode_attention(ctx.local(q), k_cache.to_local(), v_cache.to_local(),
                                      cache_len), k_cache)


def decode_attention_seqpar(q: torch.Tensor, k_cache: DTensor, v_cache: DTensor,
                            cache_len: int) -> DTensor:
    """Decode attention over a cache cut by positions over the model axis
    (k/v_cache ``Shard(1)`` of ``[B, Smax, Hkv, hd]``, rank ``i`` holding
    rows ``[i·Smax/n, (i+1)·Smax/n)``): q ``[B, 1, H, hd]`` made whole (a
    small all-gather), each rank's float32 partial ``(o, m, l)`` over its
    rows masked at ``cache_len`` by global position, and the partials
    combined over the axis: the max all-reduced, then ``o·e^(m−M)`` and
    ``l·e^(m−M)`` summed (one all-reduce).  A rank whose rows all lie at or
    past ``cache_len`` computes nothing and adds zeros.  Returns the output
    cut by q heads (``Shard(2)``) where the axis divides them, else whole."""
    import torch.distributed as dist

    mesh = k_cache.device_mesh
    q = ctx.local(q)
    kl, vl = k_cache.to_local(), v_cache.to_local()
    B, _, H, hd = q.shape
    Hkv, rows = kl.shape[2], kl.shape[1]
    G = H // Hkv
    lo = mesh.get_local_rank() * rows
    if lo < cache_len:
        qg = q.reshape(B, Hkv, G, hd)
        s = torch.einsum("bkgd,bskd->bkgs", qg.float(), kl.float()) * (1.0 / math.sqrt(hd))
        pos = lo + torch.arange(rows, device=q.device)
        s = s.masked_fill(pos >= cache_len, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        o, l = torch.einsum("bkgs,bskd->bkgd", p, vl.float()), p.sum(dim=-1)
    else:
        o = torch.zeros(B, Hkv, G, hd, dtype=torch.float32, device=q.device)
        m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(B, Hkv, G, dtype=torch.float32, device=q.device)
    group = mesh.get_group()
    m_all = m.clone()
    dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
    o, l = _rescaled(o, m, l, m_all)
    ol = torch.cat([o, l[..., None]], dim=-1)
    dist.all_reduce(ol, op=dist.ReduceOp.SUM, group=group)
    out = (ol[..., :hd] / torch.clamp(ol[..., hd:], min=1e-30)).reshape(B, 1, H, hd)
    out = out.to(q.dtype)
    out = DTensor.from_local(out, mesh, [Replicate()], run_check=False)
    return out.redistribute(mesh, [Shard(2)]) if H % mesh.size() == 0 else out


def update_kv_cache(k_cache, v_cache, k_new, v_new, cache_len: int):
    """Write ``[B, T, Hkv, hd]`` new keys/values at position ``cache_len``,
    in place (the reference returns updated copies), and return the
    caches.  A DTensor cache is written in the rank's own shard: its kv
    heads of the new rows (a cache cut by heads), the new rows that fall in
    its positions (cut by positions), or all of them (whole)."""
    if isinstance(k_cache, DTensor):
        _write_cut(k_cache, k_new, cache_len)
        _write_cut(v_cache, v_new, cache_len)
        return k_cache, v_cache
    T = k_new.shape[1]
    k_cache[:, cache_len:cache_len + T] = k_new.to(k_cache.dtype)
    v_cache[:, cache_len:cache_len + T] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def _write_cut(cache: DTensor, new, t: int) -> None:
    """Rows ``[t, t + T)`` of ``new`` ``[B, T, Hkv, hd]`` into the rank's
    shard of ``cache`` (its local tensor, which shares the cache's
    storage)."""
    mesh, local = cache.device_mesh, cache.to_local()
    if cache.placements[0] == Shard(2):
        new = ctx.enter(new, cache).redistribute(mesh, [Shard(2)]).to_local()
    else:
        new = ctx.local(new)
    T = new.shape[1]
    lo = mesh.get_local_rank() * local.shape[1] if cache.placements[0] == Shard(1) else 0
    a, b = max(t, lo), min(t + T, lo + local.shape[1])
    if a < b:
        local[:, a - lo:b - lo] = new[:, a - t:b - t].to(local.dtype)
