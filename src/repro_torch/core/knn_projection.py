"""Exact replacement for the paper's MIQP-NN optimizer.

Port of ``repro/core/knn_projection.py``.  The paper finds the K nearest
feasible assignments to a continuous proto-action â ∈ R^{N×M} with K MIQP
solves.  The feasible set is a product of row simplices, so the squared
distance decomposes per row:

    ||a − â||² = Σ_i (1 − 2·â[i, j_i] + ||â_i||²)

and the k-th nearest assignment differs from the 1-NN (row-wise argmax) by
"flipping" rows to lower-ranked columns at per-row regret
Δ[i, c] = 2·(â[i, (1)] − â[i, (c)]).  Finding the K nearest is then the
k-smallest-sums problem over N regret ladders: solved exactly by a
best-first heap on the host (numpy), or approximately-exactly by a
candidate beam over the cheapest single/pair/triple flips on the device.

The beam's per-row top-2/regret reduction runs through the hand-written
kernel (``kernels/knn_topk``) for CUDA tensors."""
from __future__ import annotations

import functools
import heapq
import itertools

import numpy as np
import torch

from repro_torch.kernels.knn_topk import row_top2_regret


# --------------------------------------------------------------------------
# Host path: exact best-first k-best enumeration (numpy copy).
# --------------------------------------------------------------------------
def knn_assignments_exact(proto: np.ndarray, k: int) -> np.ndarray:
    """Exact K nearest one-hot assignments to ``proto`` ([N, M]).

    Returns the chosen columns ``[k, N]``, ordered by distance."""
    proto = np.asarray(proto, dtype=np.float64)
    n, m = proto.shape
    order = np.argsort(-proto, axis=1)                   # [N, M] cols by desc value
    sorted_vals = np.take_along_axis(proto, order, axis=1)
    # regret ladder: cost of moving row i from rank 0 to rank c
    regret = 2.0 * (sorted_vals[:, :1] - sorted_vals)    # [N, M], col 0 = 0

    start = (0.0, tuple([0] * n))
    heap = [start]
    seen = {start[1]}
    out = []
    while heap and len(out) < k:
        cost, ranks = heapq.heappop(heap)
        out.append(ranks)
        for i in range(n):
            c = ranks[i] + 1
            if c >= m:
                continue
            nxt = list(ranks)
            nxt[i] = c
            nxt_t = tuple(nxt)
            if nxt_t in seen:
                continue
            seen.add(nxt_t)
            heapq.heappush(heap, (cost - regret[i, ranks[i]] + regret[i, c], nxt_t))

    cols = np.stack([
        order[np.arange(n), np.asarray(ranks)] for ranks in out
    ])                                                    # [k', N]
    if cols.shape[0] < k:                                 # degenerate tiny spaces
        cols = np.concatenate([cols, np.repeat(cols[-1:], k - cols.shape[0], 0)])
    return cols


def knn_actions_exact(proto: np.ndarray, k: int) -> np.ndarray:
    """One-hot action set [k, N, M] (host / numpy)."""
    proto = np.asarray(proto)
    n, m = proto.shape
    cols = knn_assignments_exact(proto, k)
    return np.eye(m, dtype=np.float32)[cols]              # [k, N, M]


# --------------------------------------------------------------------------
# Device path: the candidate beam, batched over any leading axes.
#
# Candidates: the 1-NN, all single-row flips of the `pool` cheapest rows,
# plus pair and triple combinations of the cheapest flips.  It always
# contains the exact 1-NN and only feasible actions.
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _candidates(pool: int, pair_pool: int, triple_pool: int, device: str):
    """Static candidate structure on ``device``, in the reference's
    enumeration order: flip masks ``[C, pool]`` and the pool positions
    summed for each candidate's cost, ``[C, 3]`` (``pool`` = a zero term).
    Cached, so the beam does not copy it to the device on every call."""
    combos = [()]
    combos += [(i,) for i in range(pool)]
    combos += list(itertools.combinations(range(min(pair_pool, pool)), 2))
    combos += list(itertools.combinations(range(min(triple_pool, pool)), 3))
    masks = np.zeros((len(combos), pool), dtype=bool)
    terms = np.full((len(combos), 3), pool, dtype=np.int64)
    for c, combo in enumerate(combos):
        masks[c, list(combo)] = True
        terms[c, :len(combo)] = combo
    return (torch.as_tensor(masks, device=device),
            torch.as_tensor(terms, device=device))


def knn_actions(proto: torch.Tensor, k: int, pair_pool: int = 8,
                triple_pool: int = 4) -> torch.Tensor:
    """``proto [..., N, M]`` → ``[..., k, N, M]`` one-hot candidate actions,
    ordered by distance to proto — bit-identical to the reference's
    ``knn_actions_jax`` instance by instance.

    The reference ranks with ``lax.top_k``, which puts the lower index
    first on ties; ``torch.topk`` promises no tie order, so ranking here is
    a stable ascending sort."""
    *lead, n, m = proto.shape
    best_col, second_col, flip_regret = row_top2_regret(proto)   # [..., N]

    pool = min(max(pair_pool, triple_pool, k), n)
    order = torch.sort(flip_regret, dim=-1, stable=True).indices
    cheap_rows = order[..., :pool]                                # [..., pool]
    cheap_cost = flip_regret.gather(-1, cheap_rows)               # ascending

    masks, terms = _candidates(pool, pair_pool, triple_pool, str(proto.device))
    # costs as (c[i] + c[j]) + c[l], the reference's association; the zero
    # pad makes singles and pairs exact (x + 0 == x)
    padded = torch.cat([cheap_cost, cheap_cost.new_zeros(*lead, 1)], dim=-1)
    t = padded[..., terms]                                        # [..., C, 3]
    cand_costs = (t[..., 0] + t[..., 1]) + t[..., 2]              # [..., C]

    kk = min(k, cand_costs.shape[-1])
    sel = torch.sort(cand_costs, dim=-1, stable=True).indices[..., :kk]
    sel_masks = masks[sel]                                        # [..., kk, pool]
    flip = torch.zeros(*lead, kk, n, dtype=torch.bool, device=proto.device)
    flip.scatter_(-1, cheap_rows.unsqueeze(-2).expand(*lead, kk, pool), sel_masks)
    cols = torch.where(flip, second_col.unsqueeze(-2), best_col.unsqueeze(-2))
    actions = torch.nn.functional.one_hot(cols.long(), m).to(torch.float32)
    if kk < k:
        last = actions[..., -1:, :, :]
        actions = torch.cat(
            [actions, last.expand(*lead, k - kk, n, m)], dim=-3)
    return actions


def nearest_assignment(proto: torch.Tensor) -> torch.Tensor:
    """Exact 1-NN: row-wise argmax, one-hot."""
    return torch.nn.functional.one_hot(
        proto.argmax(-1), proto.shape[-1]).to(torch.float32)


def distance_to(proto: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    return torch.square(action - proto).sum((-2, -1))
