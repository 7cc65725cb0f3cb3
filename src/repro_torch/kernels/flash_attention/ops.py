"""Wrapper of the flash-attention kernels.

On CUDA tensors it launches one of two hand-written kernels on the current
stream, chosen by dtype and by nothing else:

* bfloat16 -> ``csrc/flash_attention_sm90.cu``: Hopper tensor cores
  (``wgmma``), tiles moved by TMA.  TMA needs 16-byte-aligned bases and
  strides that are multiples of 16 bytes; a tensor that breaks either rule
  is copied into a fresh contiguous allocation first (``STAGED_COPIES``).
* float32 -> ``csrc/flash_attention.cu``: full float32 on the CUDA cores,
  as the port's float32 paths require.

Both kernels are built for the head dims in ``HEAD_DIMS`` up to 128; the
float32 kernel also for 192 and 256.  A bfloat16 head dim above 128 goes
through the same C entry point to the float32 kernel's bfloat16
instantiation (bfloat16 loads and stores, float32 math on the CUDA cores,
plain strided loads, so no TMA staging; ``LAUNCHES_BF16_CUDA_CORES``).
Any other head_dim up to 256 is zero-padded to the next native one (zero
columns add nothing to q·kᵀ and give zero output columns, sliced off),
with the scores still scaled by ``1/sqrt(true hd)`` (``LAUNCHES_PADDED``).
Any head_dim above 256, in either dtype, runs as it is on the CUDA-core
kernel's wide form, whose shared memory and registers do not grow with hd
(``LAUNCHES_WIDE``).  Padding and staging are copies in front of the same
kernel, not another route.

Non-causal attention takes k, v of a length ``Skv`` of their own (an
encoder's memory under cross-attention): every route's key loop runs to
``Skv`` and masks its tail, and the bfloat16 route's K/V tensor maps take
``Skv`` as their extent.  Causal attention needs ``Skv == S``.

On CPU tensors it runs the plain version (``ref.py``).  On ``meta``
tensors (the dry-run, ``launch/dryrun.py``) it makes the card path's
checks and returns an empty ``meta`` output of the kernel's shape and
dtype, computing nothing; it records the call by its full shape in
``META_CALLS``, as the card path counts its launches.  There is no
fallback from one route to another.  ``flops`` and ``bytes_moved`` give a
call's work, which the dry-run adds to its count and ``chip_smoke.py``'s
bounds divide by the card's rates.

``flash_attention`` goes through ``FlashAttentionFn``, a
``torch.autograd.Function``. Its forward is the kernel on the card and the
plain version on the CPU, as above; under grad mode it also saves each
row's float32 log-sum-exp ``[B, H, S]`` (natural units), which the kernels
write with one store a row.  Its backward is
``csrc/flash_attention_bwd.cu`` on the card (FlashAttention-2's algorithm:
a dQ kernel that first sums D = rowsum(P ∘ dP), then a dK/dV kernel, no
atomics), routed by dtype and head dim as the forward is (bf16 up to hd
128 on the tensor cores, float32 and bf16 above 128 on the CUDA cores),
held on the card to ``ref.flash_attention_bwd_ref``, the plain version of
its algorithm; a ``meta`` route for the dry-run; and on the CPU the plain
version of the gradient, autograd of the plain forward in float32 (the
CPU's training tests are held to the reference's steps leaf by leaf, and
an int8-compressed step there rounds a gradient that sits on a rounding
boundary: see ``_backward``). Its launches and meta calls have counters of
their own (``LAUNCHES_BWD``, ``LAUNCHES_BWD_BY_CALL``,
``META_CALLS_BWD``), so the forward's count forwards only.  ``flops_bwd``
and ``bytes_moved_bwd`` give a backward call's work."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention"
# (q, k, v, o, lse, causal, B, S, Skv, H, Hkv, hd, scale_hd, strides, stream):
# lse a float32 [B, H, S] or null, Skv k's and v's length, hd the kernel's
# head dim, scale_hd the one whose 1/sqrt scales the scores
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
         + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
# (q, k, v, dO, lse, D, dq, dk, dv, causal, B, S, Skv, H, Hkv, hd, scale_hd,
# strides of the seven tensors, stream)
_BWD_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
ENTRY = {torch.float32: "flash_attention_fwd_f32",
         torch.bfloat16: "flash_attention_fwd_bf16"}
ENTRY_BWD = {torch.float32: "flash_attention_bwd_f32",
             torch.bfloat16: "flash_attention_bwd_bf16"}
SIGNATURES = {**{fn: (_ARGS, ctypes.c_int) for fn in ENTRY.values()},
              **{fn: (_BWD_ARGS, ctypes.c_int) for fn in ENTRY_BWD.values()}}
HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)   # native head dims
TMA_HEAD_DIM = 128        # the bfloat16 wgmma kernel's largest; above, CUDA cores
TMA_ALIGN = 16                             # bytes, for bases and strides

# kernel launches since the last reset (the plain CPU path does not count):
# both routes, and each route on its own
LAUNCHES = 0
LAUNCHES_F32 = 0
LAUNCHES_BF16 = 0
# launches whose head_dim was zero-padded to a native one, bf16 tensors
# copied because TMA could not load them where they lay, and bf16 launches
# above TMA_HEAD_DIM (the CUDA-core kernel's bfloat16 instantiation)
LAUNCHES_PADDED = 0
STAGED_COPIES = 0
LAUNCHES_BF16_CUDA_CORES = 0
# launches above the largest native head dim (the CUDA-core kernel's wide
# form, either dtype)
LAUNCHES_WIDE = 0
# launches by shape, keyed "S x Skv causal|full dtype" (as "2048x4096 full
# bfloat16"): cleared by the caller, as the counts above are reset
LAUNCHES_BY_SHAPE: dict[str, int] = {}
# launches by the whole call, keyed by ``call_key`` (the batch and the head
# counts too, so a tensor-parallel rank's local heads show): cleared by the
# caller
LAUNCHES_BY_CALL: dict[str, int] = {}
# calls on meta tensors, keyed by (B, S, Skv, H, Hkv, hd, causal, dtype):
# cleared by the caller
META_CALLS: dict[tuple, int] = {}
# the backward's own: calls that launched the backward kernels (both
# routes), of them those on the bf16 tensor cores, the launches by
# ``call_key`` and the calls on meta tensors by the key of ``META_CALLS``
# (its copies for cp.async count in ``STAGED_COPIES``)
LAUNCHES_BWD = 0
LAUNCHES_BWD_TC = 0
LAUNCHES_BWD_BY_CALL: dict[str, int] = {}
META_CALLS_BWD: dict[tuple, int] = {}


def shape_key(S: int, Skv: int, causal: bool, dtype: torch.dtype) -> str:
    """The key of ``LAUNCHES_BY_SHAPE`` for a call at these sizes."""
    return f"{S}x{Skv} {'causal' if causal else 'full'} {str(dtype).removeprefix('torch.')}"


def call_key(B: int, S: int, Skv: int, H: int, Hkv: int, hd: int, causal: bool,
             dtype: torch.dtype) -> str:
    """The key of ``LAUNCHES_BY_CALL`` (and of the dry-run's ``by_call``):
    q's shape and k's length and heads, as "q[2,2048,2,128] kv[2048,1]
    causal bfloat16"."""
    return (f"q[{B},{S},{H},{hd}] kv[{Skv},{Hkv}] "
            + shape_key(S, Skv, causal, dtype).split(" ", 1)[1])


def flops(B: int, S: int, Skv: int, H: int, hd: int, causal: bool) -> int:
    """The operations of one call: q·kᵀ and p·v, 2·hd each a score, over the
    scores the kernel computes (j ≤ i when causal, which needs Skv = S)."""
    return 4 * B * H * hd * (S * (S + 1) // 2 if causal else S * Skv)


def bytes_moved(B: int, S: int, Skv: int, H: int, Hkv: int, hd: int,
                dtype: torch.dtype) -> int:
    """The bytes one call must move: q and k, v read once, o written once."""
    return (2 * B * S * H * hd + 2 * B * Skv * Hkv * hd) * dtype.itemsize


def flops_bwd(B: int, S: int, Skv: int, H: int, hd: int, causal: bool) -> int:
    """The useful operations of one backward call: q·kᵀ, dO·vᵀ, Pᵀ·dO,
    dSᵀ·q and dS·k, 2·hd each a computed score, 2.5 × ``flops``."""
    return 5 * flops(B, S, Skv, H, hd, causal) // 2


def bytes_moved_bwd(B: int, S: int, Skv: int, H: int, Hkv: int, hd: int,
                    dtype: torch.dtype) -> int:
    """The bytes one backward call must move: q, k, v, dO and the float32
    lse read once, dq, dk and dv written once."""
    return ((3 * B * S * H * hd + 4 * B * Skv * Hkv * hd) * dtype.itemsize
            + 4 * B * H * S)


def _check_tma_layout(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        size = t.element_size()
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"flash_attention: {name} starts at an address that is "
                             f"not {TMA_ALIGN}-byte aligned, which the bfloat16 "
                             "kernel's TMA loads need")
        if any(st * size % TMA_ALIGN for st in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} has strides {t.stride()} whose "
                             f"b, s, h steps are not multiples of {TMA_ALIGN} bytes, "
                             "which the bfloat16 kernel's TMA loads need")


def _stage_for_tma(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when TMA (or the backward's 16-byte ``cp.async``) can
    load it where it lies, else a copy in a fresh contiguous allocation (a
    native head_dim's rows are 32-byte multiples, and the allocator's bases
    512-byte aligned; a meta tensor's base reads as 0, aligned)."""
    global STAGED_COPIES
    size = t.element_size()
    if t.data_ptr() % TMA_ALIGN == 0 and not any(
            st * size % TMA_ALIGN for st in t.stride()[:3]):
        return t
    STAGED_COPIES += 1
    return t.clone(memory_format=torch.contiguous_format)


def _padded_head_dim(hd: int) -> int:
    """The smallest native head dim that holds ``hd``; above the largest
    (256), ``hd`` itself, which the kernel's wide form runs as it is."""
    return next((d for d in HEAD_DIMS if d >= hd), hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q ``[B, S, H, hd]``; k, v ``[B, Skv, Hkv, hd]``, one dtype (float32 or
    bfloat16), H a multiple of Hkv, the last axis contiguous →
    ``[B, S, H, hd]`` in q's dtype.  ``Skv`` ≥ 1 may differ from S when
    ``causal`` is False; causal attention needs ``Skv == S``.  Query head h
    reads kv head ``h // (H // Hkv)``; scores are scaled by
    ``1/sqrt(hd)``.  On the card hd may be any positive size.
    Differentiable through ``FlashAttentionFn``."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttentionFn.apply(q, k, v, causal, grad)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient.  Forward: the kernel on CUDA
    tensors, the plain version on CPU tensors; with ``save`` (an input
    requires grad under grad mode) it also keeps each row's log-sum-exp
    and saves ``(q, k, v, lse)``.  Backward: the backward kernels on
    CUDA tensors, the plain version on CPU tensors, its gradients in the
    inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, save):
        ctx.causal = causal
        if not save:
            return _forward(q, k, v, causal)
        o, lse = _forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, lse)
        return o

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, lse = ctx.saved_tensors
        return (*_backward(q, k, v, lse, grad_out, ctx.causal), None, None)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             with_lse: bool = False):
    """The forward of ``flash_attention``: checks, then the kernel on the
    card or the plain version on the CPU; with ``with_lse`` also the
    float32 log-sum-exp ``[B, H, S]`` of each row's scaled scores."""
    global LAUNCHES, LAUNCHES_F32, LAUNCHES_BF16, LAUNCHES_PADDED
    global LAUNCHES_BF16_CUDA_CORES, LAUNCHES_WIDE
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q, k, v of rank 4 [B, S, H, hd]")
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Hkv, hd) or v.shape != k.shape or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)}")
    if causal and Skv != S:
        raise ValueError(f"flash_attention: causal attention needs k and v as long "
                         f"as q ({S} rows), got {Skv}")
    if Skv == 0 and q.numel():
        raise ValueError("flash_attention: q's rows have no key to attend to")
    if q.dtype not in ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, with_lse=with_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not {q.device}")
    kd = _padded_head_dim(hd)
    wide = kd > HEAD_DIMS[-1]
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs the head_dim axis contiguous")
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse
           else None)
    if q.numel() == 0:
        o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
        return (o, lse) if with_lse else o
    if q.device.type == "meta":
        key = (B, S, Skv, H, Hkv, hd, causal, q.dtype)
        META_CALLS[key] = META_CALLS.get(key, 0) + 1
        o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
        return (o, lse) if with_lse else o
    if kd != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, kd - hd)) for t in (q, k, v))
    tma = q.dtype == torch.bfloat16 and kd <= TMA_HEAD_DIM
    if tma:
        q, k, v = (_stage_for_tma(t) for t in (q, k, v))
        _check_tma_layout(q=q, k=k, v=v)
    o = torch.empty((B, S, H, kd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, o)
                                      for st in t.stride()[:3]))
    lib = _build.load(NAME, SIGNATURES)
    entry = ENTRY[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            int(causal), B, S, Skv, H, Hkv, kd, hd, strides, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_WIDE += wide
    key = shape_key(S, Skv, causal, q.dtype)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    key = call_key(B, S, Skv, H, Hkv, hd, causal, q.dtype)
    LAUNCHES_BY_CALL[key] = LAUNCHES_BY_CALL.get(key, 0) + 1
    if q.dtype == torch.bfloat16:
        LAUNCHES_BF16 += 1
        LAUNCHES_BF16_CUDA_CORES += not tma
    else:
        LAUNCHES_F32 += 1
    if kd != hd:
        LAUNCHES_PADDED += 1
        o = o[..., :hd].contiguous()
    return (o, lse) if with_lse else o


def _backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
              do: torch.Tensor, causal: bool):
    """The backward of ``flash_attention``: ``(dq, dk, dv)`` from the
    forward's inputs and log-sum-exp and the output gradient ``do``: the
    card route's allocations (the dQ kernel's float32 D workspace
    ``[B, H, S]`` among them) and, on the card, its launch.  On the CPU,
    the gradient's plain version: the plain forward rerun in float32 and
    differentiated by autograd.  ``flash_attention_bwd_ref`` (the kernels'
    algorithm) differs from it in the last float32 bits, and
    tests/test_torch_trainer.py's int8-compressed llama3-8b step holds the
    CPU step to the reference's at a gradient element 2e-6 from an int8
    rounding boundary, where float64 lands on the other side too."""
    global LAUNCHES_BWD, LAUNCHES_BWD_TC
    if q.device.type == "cpu":
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
            o = flash_attention_ref(*leaves, causal=causal)
            grads = torch.autograd.grad(o, leaves, do.float())
        return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_attention backward: the output gradient "
                         f"{tuple(do.shape)} {do.dtype} does not fit q {tuple(q.shape)}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    kd = _padded_head_dim(hd)
    if kd != hd:
        q, k, v, do = (torch.nn.functional.pad(t, (0, kd - hd)) for t in (q, k, v, do))
    tc = q.dtype == torch.bfloat16 and kd <= TMA_HEAD_DIM
    if tc:
        q, k, v, do = (_stage_for_tma(t) for t in (q, k, v, do))
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, S, H, kd), dtype=q.dtype, device=q.device)
    # no query row: nothing reads k, v, whose gradient is zero
    alloc = torch.zeros if q.numel() == 0 else torch.empty
    dk, dv = (alloc((B, Skv, Hkv, kd), dtype=q.dtype, device=q.device) for _ in range(2))
    if q.device.type == "meta":
        key = (B, S, Skv, H, Hkv, hd, causal, q.dtype)
        META_CALLS_BWD[key] = META_CALLS_BWD.get(key, 0) + 1
    elif q.numel():
        strides = (ctypes.c_int64 * 21)(*(st for t in (q, k, v, do, dq, dk, dv)
                                          for st in t.stride()[:3]))
        lib = _build.load(NAME, SIGNATURES)
        entry = ENTRY_BWD[q.dtype]
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = getattr(lib, entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                int(causal), B, S, Skv, H, Hkv, kd, hd, strides, stream)
        if rc != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
        LAUNCHES_BWD += 1
        LAUNCHES_BWD_TC += tc
        key = call_key(B, S, Skv, H, Hkv, hd, causal, q.dtype)
        LAUNCHES_BWD_BY_CALL[key] = LAUNCHES_BWD_BY_CALL.get(key, 0) + 1
    if kd != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv
