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
``torch.autograd.Function``: its forward is the kernel on the card and the
plain version on the CPU, as above; its backward recomputes the plain
version in float32 and differentiates it (no kernel launch), until a
hand-written backward kernel takes its place (ROADMAP B2 item 1)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention"
# (q, k, v, o, causal, B, S, Skv, H, Hkv, hd, scale_hd, strides, stream): Skv
# is k's and v's length, hd the kernel's head dim, scale_hd the one whose
# 1/sqrt scales the scores
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
         + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
ENTRY = {torch.float32: "flash_attention_fwd_f32",
         torch.bfloat16: "flash_attention_fwd_bf16"}
SIGNATURES = {fn: (_ARGS, ctypes.c_int) for fn in ENTRY.values()}
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
    """``t`` itself when TMA can load it where it lies, else a copy in a
    fresh contiguous allocation (a native head_dim's rows are 32-byte
    multiples, and the allocator's bases 512-byte aligned)."""
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
    return FlashAttentionFn.apply(q, k, v, causal)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient.  Forward: the kernel on CUDA
    tensors, the plain version on CPU tensors.  Backward: a plain
    recompute, the reference function (``ref.py``) rerun in float32 from
    the saved q, k, v and differentiated by autograd, its gradients
    returned in the inputs' dtypes.  It materializes the ``[B, H, S, Skv]``
    scores, so it is the memory bound of a training step's attention,
    until B2 item 1 brings a backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
            o = flash_attention_ref(*leaves, causal=ctx.causal)
            grads = torch.autograd.grad(o, leaves, grad_out.float())
        return (*(g.to(t.dtype) for g, t in zip(grads, (q, k, v))), None)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> torch.Tensor:
    """The forward of ``flash_attention``: checks, then the kernel on the
    card or the plain version on the CPU."""
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
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not {q.device}")
    kd = _padded_head_dim(hd)
    wide = kd > HEAD_DIMS[-1]
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs the head_dim axis contiguous")
    if q.numel() == 0:
        return torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        key = (B, S, Skv, H, Hkv, hd, causal, q.dtype)
        META_CALLS[key] = META_CALLS.get(key, 0) + 1
        return torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
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
    return o
