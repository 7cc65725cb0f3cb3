"""Activation-sharding context (``repro/sharding/ctx.py``).

Model code calls ``constrain(x, "dp", None, "tp")`` at the reference's
activation boundaries.  With no mesh set (every single-device caller) it
returns its argument unchanged, so the numbers are those of a model without
the calls.  Under a mesh (:func:`use_mesh`, which the meshed train step
sets) a DTensor argument is redistributed to the divisibility-checked spec,
as the reference's ``with_sharding_constraint``; a plain tensor is returned
as it is.  The meshed train step hands the model plain local tensors (the
parameters gathered where they are used), so on its path every
``constrain`` returns its argument: compute on the ``model`` axis is
replicated, and the calls mark where tensor-parallel compute will cut.

The port adds one reduction the reference leaves to GSPMD: when the train
step cuts a microbatch's rows over the data axes (:func:`cut_batch`),
:func:`batch_sum` sums a per-rank partial over them, so a mean over the
batch (the loss's token count, the MoE's load-balancing statistics) is the
global batch's."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding.policy import (P, axis_size as _axis_size, mesh_axis_sizes,
                                         placements)

_STATE: dict = {"mesh": None, "dp": (), "tp": "model", "batch": ()}


def set_mesh(mesh) -> None:
    if mesh is None:
        _STATE.update(mesh=None, dp=(), batch=())
        return
    names = tuple(mesh_axis_sizes(mesh))
    _STATE.update(mesh=mesh, dp=tuple(n for n in names if n != "model"),
                  tp="model" if "model" in names else None, batch=())


@contextlib.contextmanager
def use_mesh(mesh):
    prev = _STATE["mesh"]
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(prev)


def axis_size(which: str) -> int:
    """Size of the 'dp'/'tp' axis group under the active mesh (1 if none)."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return 1
    axes = _STATE["dp"] if which == "dp" else _STATE["tp"]
    if not axes:
        return 1
    return _axis_size(mesh, axes)


def divides(dim: int, which: str) -> bool:
    return dim % axis_size(which) == 0


def constrain_spec(shape, *axes) -> Optional[P]:
    """The spec :func:`constrain` gives a tensor of ``shape`` under the
    active mesh (None without one): each "dp"/"tp" entry becomes its mesh
    axes where they divide the dimension, else None."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    spec = []
    for dim, a in zip(shape, axes):
        if a is None:
            spec.append(None)
            continue
        mesh_axes = _STATE["dp"] if a == "dp" else _STATE["tp"]
        if mesh_axes and dim % _axis_size(mesh, mesh_axes) == 0:
            spec.append(mesh_axes)
        else:
            spec.append(None)
    return P(*spec)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """axes: per-dim "dp" | "tp" | None.  Non-divisible dims are left
    unsharded rather than erroring.  Without a mesh, or for a plain tensor,
    ``x`` itself; a DTensor is redistributed to the spec's placements on
    its own device mesh."""
    spec = constrain_spec(x.shape, *axes)
    if spec is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


# -- the data axes a microbatch's rows are cut over -----------------------------
@contextlib.contextmanager
def cut_batch(axes: tuple[str, ...]):
    """While the block runs, each rank holds its own rows of the batch, cut
    over the mesh axes ``axes`` (a DeviceMesh's data axes; empty when the
    batch is replicated)."""
    prev = _STATE["batch"]
    _STATE["batch"] = tuple(axes)
    try:
        yield
    finally:
        _STATE["batch"] = prev


def batch_split() -> int:
    """How many ways the batch's rows are cut (1 outside :func:`cut_batch`)."""
    if _STATE["mesh"] is None or not _STATE["batch"]:
        return 1
    return _axis_size(_STATE["mesh"], _STATE["batch"])


class _SumOverBatch(torch.autograd.Function):
    """All-reduce (sum) over the groups of the batch's mesh axes; the
    backward passes each rank's gradient through unchanged, so a rank's
    parameters receive its own rows' share of the global batch's gradient,
    and the ranks' shares sum (``Partial``) to the whole of it."""

    @staticmethod
    def forward(ctx, x, groups):
        out = x.clone()
        for g in groups:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks that hold other rows of the batch
    (differentiable); ``x`` itself when the batch is not cut."""
    if batch_split() == 1:
        return x
    mesh = _STATE["mesh"]
    names = list(mesh_axis_sizes(mesh))
    groups = [mesh.get_group(names.index(a)) for a in _STATE["batch"]]
    return _SumOverBatch.apply(x, groups)
