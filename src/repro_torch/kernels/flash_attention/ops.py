"""Wrapper of the flash-attention kernel.

On CUDA tensors it launches the hand-written kernel
(``csrc/flash_attention.cu``) on the current stream; on CPU tensors it
runs the plain version (``ref.py``).  There is no fallback from one to
the other."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention"
SIGNATURES = {"flash_attention_fwd": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p], ctypes.c_int)}
HEAD_DIMS = (16, 32, 64, 128)              # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (the plain CPU path does not count)
LAUNCHES = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q ``[B, S, H, hd]``; k, v ``[B, S, Hkv, hd]``, one dtype (float32 or
    bfloat16), H a multiple of Hkv, the last axis contiguous →
    ``[B, S, H, hd]`` in q's dtype.  Query head h reads kv head
    ``h // (H // Hkv)``; scores are scaled by ``1/sqrt(hd)``."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q, k, v of rank 4 [B, S, H, hd]")
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, hd) or v.shape != k.shape or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs the head_dim axis contiguous")
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_int64 * 12)(*(st for t in (q, k, v, o)
                                      for st in t.stride()[:3]))
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], int(causal), B, S, H, Hkv, hd, strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return o
