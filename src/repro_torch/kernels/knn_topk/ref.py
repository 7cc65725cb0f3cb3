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


def edge_rows(m: int) -> tuple[tuple[str, ...], torch.Tensor]:
    """Rows of m ≥ 2 columns where the order of values is not plain: NaN
    (first, middle, last, twice, beside ±inf), ±inf, all -inf, values
    below the mask value -1e30 or tied with it, -0.0 beside 0.0, and ties.
    Returns their names and a ``[rows, m]`` float32 tensor; the checks of
    the kernel and of the plain version feed them."""
    nan, inf = float("nan"), float("inf")
    perm = torch.randperm(m, generator=torch.Generator().manual_seed(m))
    base = perm.float() / m + 0.25                    # distinct, in [0.25, 1.25)
    mid, last = m // 2, m - 1
    two = (1, last) if m > 2 else (0, 1)
    rows = {
        "nan_first": {0: nan},
        "nan_middle": {mid: nan},
        "nan_last": {last: nan},
        "two_nans": {two[0]: nan, two[1]: nan},
        "nan_and_inf": {0: inf, last: nan},
        "nan_and_neg_inf": {0: -inf, mid: nan},
        "inf": {mid: inf},
        "two_infs": {0: inf, last: inf},
        "neg_inf": {0: -inf},
        "best_then_neg_infs": {j: -inf for j in range(1, m)},
        "all_neg_inf": {j: -inf for j in range(m)},
        "below_mask": {j: -2e30 - float(base[j]) * 1e30 for j in range(m)},
        "best_then_below_mask": {j: -2e30 for j in range(1, m)},
        "tied_with_mask": {j: -1e30 for j in range(1, m)},
        "neg_zero_first": {0: -0.0, 1: 0.0, **{j: -1.0 for j in range(2, m)}},
        "zero_first": {0: 0.0, 1: -0.0, **{j: -1.0 for j in range(2, m)}},
        "all_tied": {j: 0.5 for j in range(m)},
        "two_maxima": {0: float(base.max()), int(base.argmax()): float(base.max())},
    }
    out = base.repeat(len(rows), 1)
    for i, at in enumerate(rows.values()):
        for j, x in at.items():
            out[i, j] = x
    return tuple(rows), out
