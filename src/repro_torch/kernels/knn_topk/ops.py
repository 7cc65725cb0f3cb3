"""Wrapper of the K-NN row-reduction kernel.

On a CUDA tensor it launches the hand-written kernel (``csrc/knn_topk.cu``)
on the current stream; on a CPU tensor it runs the plain version
(``ref.py``).  There is no fallback from one to the other."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.knn_topk.ref import row_top2_regret_ref

NAME = "knn_topk"
SIGNATURES = {"knn_row_top2_regret": (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)}

# kernel launches since the last reset (the plain CPU path does not count)
LAUNCHES = 0


def row_top2_regret(proto: torch.Tensor):
    """proto ``[..., M]`` float32, contiguous, M ≥ 2 → (best ``[...]`` int32,
    second ``[...]`` int32, regret ``[...]`` float32).

    All leading axes are flattened into rows, so a fleet's whole select
    (``[F, N, M]``) or update (``[F, B, N, M]``) is one launch."""
    global LAUNCHES
    if proto.dtype != torch.float32:
        raise TypeError(f"row_top2_regret takes float32, got {proto.dtype}")
    if proto.dim() < 1 or proto.shape[-1] < 2:
        raise ValueError(f"row_top2_regret needs rows of >= 2 columns, got "
                         f"shape {tuple(proto.shape)}")
    if not proto.is_contiguous():
        raise ValueError("row_top2_regret takes a contiguous tensor")
    if proto.device.type == "cpu":
        return row_top2_regret_ref(proto)
    if proto.device.type != "cuda":
        raise ValueError(f"row_top2_regret runs on cuda or cpu, not "
                         f"{proto.device}")
    lead, m = proto.shape[:-1], proto.shape[-1]
    best = torch.empty(lead, dtype=torch.int32, device=proto.device)
    second = torch.empty(lead, dtype=torch.int32, device=proto.device)
    regret = torch.empty(lead, dtype=torch.float32, device=proto.device)
    rows = best.numel()
    if rows == 0:
        return best, second, regret
    lib = _build.load(NAME, SIGNATURES)
    with torch.cuda.device(proto.device):
        stream = torch.cuda.current_stream(proto.device).cuda_stream
        rc = lib.knn_row_top2_regret(proto.data_ptr(), best.data_ptr(),
                                     second.data_ptr(), regret.data_ptr(),
                                     rows, m, stream)
    if rc != 0:
        raise RuntimeError(f"knn_row_top2_regret launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return best, second, regret
