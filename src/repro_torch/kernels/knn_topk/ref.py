"""Plain PyTorch version of the K-NN row-reduction kernel.

Mirrors the Pallas body ``repro/kernels/knn_topk/kernel.py::_top2_kernel``:
argmax, mask the best column to −1e30, argmax again.  ``torch.argmax``
returns the first index of the maximum, as ``jnp.argmax`` does."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def row_top2_regret_ref(proto: torch.Tensor):
    """proto ``[..., M]`` float32 → (best ``[...]`` int32, second ``[...]``
    int32, regret ``[...]`` float32), with
    regret = 2·(proto[best] − proto[second])."""
    best = proto.argmax(-1, keepdim=True)
    cols = torch.arange(proto.shape[-1], device=proto.device)
    masked = torch.where(cols == best, NEG_INF, proto)
    second = masked.argmax(-1, keepdim=True)
    best_val = proto.gather(-1, best)
    second_val = masked.gather(-1, second)
    regret = 2.0 * (best_val - second_val)
    return (best[..., 0].to(torch.int32), second[..., 0].to(torch.int32),
            regret[..., 0])
