"""Activation-sharding context (``repro/sharding/ctx.py``).

Model code calls ``constrain(x, "dp", None, "tp")`` at the reference's
activation boundaries.  With no mesh set (every single-device caller) it
returns its argument unchanged, so the numbers are those of a model without
the calls.  Under a mesh (:func:`use_mesh`, which the meshed train step,
the tensor-parallel decode and the dry-run set) a DTensor argument is
redistributed to the divisibility-checked spec, as the reference's
``with_sharding_constraint``; a plain tensor is returned as it is.

The meshed train step, the dry-run's prefill and the tensor-parallel decode
(``lm.serve_step``) compute tensor-parallel on the ``model`` axis.  The
parameters are gathered over the data axes only, one block's at a time
just before the block runs (``sharding/gather.py``), and each leaf's
``model``-axis shard is handed to the block as a DTensor on the 1-D
``model`` sub-mesh; a decode cache's
leaves are the rank's shards rewrapped there alike
(``trainer.cache_model_shards``: K/V cut by kv heads or by positions, the
RWKV state by heads, the Mamba state by ``d_inner``).  Activations are
DTensors on that sub-mesh too: :func:`enter` makes a plain activation a
``Replicate()`` one where the parameters it meets are DTensors, DTensor's
matmul rules give column- then row-parallel products (the row-parallel
output ``Partial``), and ``constrain`` at the reference's points
redistributes over the model axis alone (a ``"dp"`` entry names no axis of
the sub-mesh).  :func:`local` turns a DTensor back into a plain tensor,
whole.

The MoE FFN and the Mamba mixer run on the rank's local tensors (its
experts or its slice of each expert's d_ff; its ``d_inner`` channels)
between Megatron's two conjugate operators: *f*, :func:`local_input`, a
whole activation entering rank-local compute (the identity; backward, the
rank's partial gradient made whole by an all-reduce), and *g*,
:func:`sum_over`, a rank's partial output made whole (an all-reduce; the
identity backward).

The port adds one reduction the reference leaves to GSPMD: when the train
step cuts a microbatch's rows over the data axes (:func:`cut_batch`),
:func:`batch_sum` sums a per-rank partial over them, so a mean over the
batch (the loss's token count, the MoE's load-balancing statistics) is the
global batch's.  The data axes never appear in an activation's
placements."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

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


# -- the boundaries of the tensor-parallel blocks ------------------------------
def enter(x: torch.Tensor, like) -> torch.Tensor:
    """``x`` as a ``Replicate()`` DTensor on ``like``'s device mesh when
    ``like`` (a parameter the activation meets) is a DTensor; else ``x``.
    ``x`` is the same on every rank of that mesh."""
    if not isinstance(like, DTensor) or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, like.device_mesh, [Replicate()] * like.device_mesh.ndim,
                              run_check=False)


def local(x):
    """A DTensor gathered whole on every rank of its mesh, as a plain tensor
    (differentiable); any other value as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim).to_local()


class _WholeGrad(torch.autograd.Function):
    """The identity; in the backward a ``Partial`` gradient is made whole
    (an all-reduce over its mesh)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and any(p.is_partial() for p in grad.placements):
            grad = grad.redistribute(grad.device_mesh, [Replicate()] * grad.device_mesh.ndim)
        return grad


def tp_input(x: torch.Tensor) -> torch.Tensor:
    """A whole activation entering tensor-parallel products: the identity
    forward; backward, the ``Partial`` sum of its branches' gradients made
    whole (an all-reduce), so the residual stream's gradient stays
    ``Replicate()`` and every product's backward stays cut (a ``Partial``
    gradient would make DTensor gather the weights it meets).  A no-op on
    plain tensors."""
    return _WholeGrad.apply(x) if isinstance(x, DTensor) else x


def sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` all-reduced (summed) over each process group in ``groups``;
    the gradient passes through unchanged (each rank's partial feeds one
    sum that every rank uses alike).  Megatron's *g* over the model axis."""
    return _SumOver.apply(x, groups)


class _LocalInput(torch.autograd.Function):
    """The identity; in the backward the gradient all-reduced (summed) over
    ``group`` (none: passed through)."""

    @staticmethod
    def forward(ctx_, x, group):
        ctx_.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, grad):
        if ctx_.group is not None:
            grad = grad.clone()
            dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx_.group)
        return grad, None


def local_input(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: a plain activation, the same on every rank of
    ``group``, entering compute on the rank's part of the weights (its
    experts, its channels): the identity forward; backward, each rank's
    partial gradient made whole by an all-reduce over ``group``.  With
    ``group`` None (one process) the backward passes the gradient through,
    so a meshed and an unmeshed run share one autograd graph."""
    return _LocalInput.apply(x, group)


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


def batch_axes() -> tuple[str, ...]:
    """The mesh axes the batch's rows are cut over (empty outside
    :func:`cut_batch`)."""
    return _STATE["batch"] if _STATE["mesh"] is not None else ()


def batch_split() -> int:
    """How many ways the batch's rows are cut (1 outside :func:`cut_batch`)."""
    if _STATE["mesh"] is None or not _STATE["batch"]:
        return 1
    return _axis_size(_STATE["mesh"], _STATE["batch"])


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over process groups (the batch's mesh axes, or the
    model axis); the backward passes each rank's gradient through
    unchanged: every rank uses the sum alike, so a rank's partial receives
    the sum's gradient, and the ranks' shares sum (``Partial``) to the
    whole of it."""

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
    return _SumOver.apply(x, groups)
