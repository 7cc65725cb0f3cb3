"""Wrapper of the WKV6 kernel.

On CUDA tensors it launches the hand-written kernel (``csrc/wkv6.cu``) on
the current stream; on CPU tensors it runs the plain version
(``ref.py``).  On ``meta`` tensors (the dry-run, ``launch/dryrun.py``) it
makes the card path's checks and returns empty ``meta`` outputs of the
kernel's shapes and dtypes (the carried state too), computing nothing; it
records the call by shape in ``META_CALLS``, as the card path counts its
launches.  There is no fallback from one route to another.  ``flops`` and
``bytes_moved`` give a call's work, which the dry-run adds to its count
and ``chip_smoke.py``'s bounds divide by the card's rates.

``wkv6`` goes through ``WKV6Fn``, a ``torch.autograd.Function``: its
forward is the kernel on the card and the plain version on the CPU; its
backward recomputes the plain version in float32 and differentiates it
(no kernel launch), until a hand-written backward kernel takes its place
(ROADMAP B3 item 2)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

NAME = "rwkv6_scan"
SIGNATURES = {"wkv6_fwd": (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p], ctypes.c_int)}
HEAD_DIMS = (8, 16, 32, 64, 128)           # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (the plain CPU path does not count)
LAUNCHES = 0
# launches by the whole call, keyed by ``call_key`` (a tensor-parallel
# rank's local heads show): cleared by the caller
LAUNCHES_BY_CALL: dict[str, int] = {}
# calls on meta tensors, keyed by (B, T, H, hd, r's dtype, carried state):
# cleared by the caller
META_CALLS: dict[tuple, int] = {}


def call_key(B: int, T: int, H: int, hd: int, dtype: torch.dtype) -> str:
    """The key of ``LAUNCHES_BY_CALL`` (and of the dry-run's ``by_call`` and
    ``by_shape``): r's shape and dtype, as "[8,1,4,64] bfloat16"."""
    return f"[{B},{T},{H},{hd}] {str(dtype).removeprefix('torch.')}"


def flops(B: int, T: int, H: int, hd: int) -> int:
    """The operations of one call: per state element and step, r_i S_ij into
    the output (an FMA) and S_ij = w_i S_ij + k_i v_j (a product and an
    FMA); the bonus v_j sum_i r_i u_i k_i is O(hd) a step and left out."""
    return 5 * B * T * H * hd * hd


def bytes_moved(B: int, T: int, H: int, hd: int, dtype: torch.dtype,
                carried: bool) -> int:
    """The bytes one call must move: w float32, r, k, v in ``dtype`` and the
    float32 output once each; the float32 state written, and read first
    when one is carried in (u, O(H·hd), left out)."""
    state = B * H * hd * hd * 4
    return B * T * H * hd * (4 + 3 * dtype.itemsize + 4) + state * (2 if carried else 1)


def wkv6(w: torch.Tensor, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         u: torch.Tensor, S0: torch.Tensor | None = None):
    """w float32 and r, k, v (float32 or bfloat16, one dtype), all
    ``[B, T, H, hd]`` with the last axis contiguous; u float32 ``[H, hd]``;
    S0 float32 ``[B, H, hd, hd]`` or None for a zero state.  Returns
    (out float32 ``[B, T, H, hd]``, S_T float32 ``[B, H, hd, hd]``).
    Differentiable in every input through ``WKV6Fn``."""
    return WKV6Fn.apply(w, r, k, v, u, S0)


class WKV6Fn(torch.autograd.Function):
    """WKV6 with a gradient.  Forward: the kernel on CUDA tensors, the
    plain version on CPU tensors.  Backward: a plain recompute, the
    reference recurrence (``ref.py``) rerun in float32 from the saved
    inputs and differentiated by autograd (a loop over T), giving the
    gradients of w, r, k, v, u and of S0 in their dtypes, until B3 item 2
    brings a backward kernel."""

    @staticmethod
    def forward(ctx, w, r, k, v, u, S0):
        ctx.save_for_backward(w, r, k, v, u, S0)
        return _forward(w, r, k, v, u, S0)

    @staticmethod
    def backward(ctx, g_out, g_S):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().float().requires_grad_(need)
                      for t, need in zip(inputs, ctx.needs_input_grad)]
            out, S_T = wkv6_ref(*leaves)
            wanted = [x for x in leaves if x is not None and x.requires_grad]
            grads = iter(torch.autograd.grad((out, S_T), wanted,
                                             (g_out.float(), g_S.float()),
                                             allow_unused=True))
        picked = [next(grads) if x is not None and x.requires_grad else None
                  for x in leaves]
        return tuple(None if g is None else g.to(t.dtype) for g, t in zip(picked, inputs))


def _forward(w, r, k, v, u, S0):
    """The forward of ``wkv6``: checks, then the kernel on the card or the
    plain version on the CPU."""
    global LAUNCHES
    if r.dim() != 4:
        raise ValueError("wkv6 takes w, r, k, v of rank 4 [B, T, H, hd]")
    B, T, H, hd = r.shape
    if w.shape != r.shape or k.shape != r.shape or v.shape != r.shape:
        raise ValueError(f"wkv6: w {tuple(w.shape)}, r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} differ")
    if u.shape != (H, hd):
        raise ValueError(f"wkv6: u is {tuple(u.shape)}, expected {(H, hd)}")
    if S0 is not None and S0.shape != (B, H, hd, hd):
        raise ValueError(f"wkv6: S0 is {tuple(S0.shape)}, expected {(B, H, hd, hd)}")
    if (w.dtype != torch.float32 or u.dtype != torch.float32
            or (S0 is not None and S0.dtype != torch.float32)):
        raise TypeError("wkv6 takes w, u and S0 in float32")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6 takes float32 or bfloat16 r, k, v of one dtype, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    tensors = (w, r, k, v, u) + (() if S0 is None else (S0,))
    if any(t.device != r.device for t in tensors):
        raise ValueError("wkv6: inputs lie on different devices")
    if r.device.type == "cpu":
        return wkv6_ref(w, r, k, v, u, S0)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6 runs on cuda, cpu or meta, not {r.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if any(t.stride(-1) != 1 for t in (w, r, k, v)):
        raise ValueError("wkv6 needs the head_dim axis contiguous")
    if not u.is_contiguous() or (S0 is not None and not S0.is_contiguous()):
        raise ValueError("wkv6 takes u and S0 contiguous")
    out = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    S_T = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return out, S_T
    if r.device.type == "meta":
        key = (B, T, H, hd, r.dtype, S0 is not None)
        META_CALLS[key] = META_CALLS.get(key, 0) + 1
        return out, S_T
    strides = (ctypes.c_int64 * 12)(*(st for t in (w, r, k, v)
                                      for st in t.stride()[:3]))
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv6_fwd(
            w.data_ptr(), r.data_ptr(), k.data_ptr(), v.data_ptr(),
            u.data_ptr(), None if S0 is None else S0.data_ptr(),
            out.data_ptr(), S_T.data_ptr(), _DTYPES[r.dtype], B, T, H, hd,
            strides, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: CUDA error {rc}")
    LAUNCHES += 1
    key = call_key(B, T, H, hd, r.dtype)
    LAUNCHES_BY_CALL[key] = LAUNCHES_BY_CALL.get(key, 0) + 1
    return out, S_T
