"""Int8 error-feedback gradient compression (``repro/train/compression.py``).

Each gradient leaf is quantized to int8 with a per-leaf scale, and the
quantization error is kept as a residual that is added back the next step
(error feedback).  ``torch.round`` rounds half to even, as ``jnp.round``
does, so the int8 values are the reference's.

The scale is global to the leaf: ``max|x|`` over all of it.  On a mesh
(``trainer.make_train_step(..., mesh=)``) each rank holds a shard of each
gradient and residual, reduced to the parameter's placements; the step
passes ``leaf_max``, which takes the shards' local maxima to the leaves'
(a MAX over the ranks that hold the leaf's other shards), so every rank
quantizes its shard with the scale of the whole leaf and the int8 values
are those of one process."""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (q int8, scale float32);
    ``amax`` is the tensor's ``max|x|`` when given (a shard's leaf's)."""
    if amax is None:
        amax = torch.max(torch.abs(x)).float()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_leaf(g: torch.Tensor, residual: torch.Tensor,
                     amax: torch.Tensor | None = None):
    """Error-feedback compress one gradient leaf: (compressed g in g's
    dtype, new residual in the residual's dtype); ``amax`` as in
    :func:`quantize_int8`, of ``g + residual``."""
    corrected = g.float() + residual.float()
    q, scale = quantize_int8(corrected, amax)
    deq = dequantize_int8(q, scale)
    return deq.to(g.dtype), (corrected - deq).to(residual.dtype)


def ef_compress_grads(grads, residuals, leaf_max=None):
    """EF-int8 on every leaf of a tree: (compressed grads, residuals).
    ``leaf_max(maxima)`` takes the list of each leaf's local ``max|g + r|``
    (in ``tree_leaves`` order) to the whole leaves' (a sharded state's)."""
    if leaf_max is None:
        both = tree_map(ef_compress_leaf, grads, residuals)
    else:
        amax = leaf_max([torch.max(torch.abs(g.float() + r.float())).float()
                         for g, r in zip(tree_leaves(grads), tree_leaves(residuals))])
        both = tree_unflatten(grads, [ef_compress_leaf(g, r, m) for g, r, m in zip(
            tree_leaves(grads), tree_leaves(residuals), amax)])
    return tree_map(lambda pair: pair[0], both), tree_map(lambda pair: pair[1], both)


def compression_error(g: torch.Tensor) -> torch.Tensor:
    """Relative L2 error of one int8 round trip (no error feedback)."""
    q, s = quantize_int8(g)
    deq = dequantize_int8(q, s)
    return torch.linalg.norm(deq - g) / torch.clamp(torch.linalg.norm(g), min=1e-12)
