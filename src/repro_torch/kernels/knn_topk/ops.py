"""Wrapper of the K-NN row-reduction kernel.

On a CUDA tensor it launches the hand-written kernel (``csrc/knn_topk.cu``)
on the current stream; on a CPU tensor it runs the plain version
(``ref.py``).  There is no fallback from one to the other.

The loop that calls it waits on the host, so a call does little there: one
allocation for the three outputs, the entry point bound once, the raw
stream handle in place of a ``torch.cuda.Stream`` object (which took longer
to make than the launch; chip_smoke.py's phase 3 times every step), and
the device switched only when the tensor is not on the current one.

When autograd records and ``proto`` requires grad, the call goes through
``RowTop2RegretFn``, whose backward gives the regret's gradient by a plain
recompute (the K-NN projection's callers run under ``no_grad``, so the
loop's calls take the direct route and pay nothing for it)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.knn_topk.ref import row_top2_regret_ref

NAME = "knn_topk"
ENTRY = "knn_row_top2_regret"
# (proto, out [3, rows] int32, rows, m, stream)
SIGNATURES = {ENTRY: (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
     ctypes.c_void_p], ctypes.c_int)}

# kernel launches since the last reset (the plain CPU path does not count),
# in all and by (rows, m) shape, the leading axes flattened into rows
LAUNCHES = 0
LAUNCHES_BY_SHAPE: dict[tuple[int, int], int] = {}
_entry = None                 # the C entry point, bound on the first launch


def _launch(proto: torch.Tensor, out: torch.Tensor, rows: int, m: int,
            index: int) -> int:
    global _entry
    if _entry is None:
        _entry = getattr(_build.load(NAME, SIGNATURES), ENTRY)
    stream = torch._C._cuda_getCurrentRawStream(index)   # cudaStream_t
    return _entry(proto.data_ptr(), out.data_ptr(), rows, m, stream)


def row_top2_regret(proto: torch.Tensor):
    """proto ``[..., M]`` float32, contiguous, M ≥ 2 → (best ``[...]`` int32,
    second ``[...]`` int32, regret ``[...]`` float32).

    All leading axes are flattened into rows, so a fleet's whole select
    (``[F, N, M]``) or update (``[F, B, N, M]``) is one launch.  On the card
    the three are rows of one ``[3, ...]`` buffer, each contiguous.  The
    regret is differentiable in ``proto`` (``RowTop2RegretFn``)."""
    if proto.requires_grad and torch.is_grad_enabled():
        return RowTop2RegretFn.apply(proto)
    return _forward(proto)


class RowTop2RegretFn(torch.autograd.Function):
    """The K-NN reduction with the regret's gradient.  Forward: the kernel
    on CUDA tensors, the plain version on CPU tensors (copies of the three
    outputs, the indices non-differentiable).  Backward: the plain version
    rerun from the saved ``proto`` and differentiated by autograd."""

    @staticmethod
    def forward(ctx, proto):
        ctx.save_for_backward(proto)
        best, second, regret = (t.clone() for t in _forward(proto))
        ctx.mark_non_differentiable(best, second)
        return best, second, regret

    @staticmethod
    def backward(ctx, g_best, g_second, g_regret):
        proto, = ctx.saved_tensors
        with torch.enable_grad():
            leaf = proto.detach().requires_grad_()
            regret = row_top2_regret_ref(leaf)[2]
            return torch.autograd.grad(regret, leaf, g_regret)[0]


def _forward(proto: torch.Tensor):
    """The forward of ``row_top2_regret``: checks, then the kernel on the
    card or the plain version on the CPU."""
    global LAUNCHES
    if proto.dtype != torch.float32:
        raise TypeError(f"row_top2_regret takes float32, got {proto.dtype}")
    if proto.dim() < 1 or proto.shape[-1] < 2:
        raise ValueError(f"row_top2_regret needs rows of >= 2 columns, got "
                         f"shape {tuple(proto.shape)}")
    if not proto.is_contiguous():
        raise ValueError("row_top2_regret takes a contiguous tensor")
    if not proto.is_cuda:
        if proto.device.type == "cpu":
            return row_top2_regret_ref(proto)
        raise ValueError(f"row_top2_regret runs on cuda or cpu, not "
                         f"{proto.device}")
    *lead, m = proto.shape
    out = proto.new_empty((3, *lead), dtype=torch.int32)
    best, second, regret = out[0], out[1], out[2].view(torch.float32)
    rows = best.numel()
    if rows == 0:
        return best, second, regret
    index = proto.get_device()
    if index == torch.cuda.current_device():
        rc = _launch(proto, out, rows, m, index)
    else:
        with torch.cuda.device(index):
            rc = _launch(proto, out, rows, m, index)
    if rc != 0:
        raise RuntimeError(f"knn_row_top2_regret launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[rows, m] = LAUNCHES_BY_SHAPE.get((rows, m), 0) + 1
    return best, second, regret
