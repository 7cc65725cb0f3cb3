"""Parameters gathered for the tensor-parallel blocks.

The placed tree (``trainer.shard_train_state``'s parameters, or a tree
placed by ``policy.params_sharding``) holds each rank's shards, cut over
the data axes and the ``model`` axis.  The tensor-parallel blocks compute on
each leaf's model-axis shard made whole over the data axes: a DTensor on
the 1-D model sub-mesh (``mesh["model"]``).  Two forms make it:

* :func:`gather_model_shards`: every leaf of a tree at once.  The model
  gathers the leaves outside the blocks so (the embedding, ``lm_head``,
  ``final_norm``, ``enc_final_norm``), once a step, as the reference
  gathers them outside its scan;
* :class:`BlockShards`: the stacked leaves of ``layers`` or ``enc_layers``
  split into each block's stored shards (views; a leaf the policy cuts by
  its block dimension recut on the model axis first), and
  :meth:`BlockShards.gather` one block's gathered just before the block
  runs, as the reference's rematerialized ``lax.scan`` gathers one block's
  data-sharded leaves at a time.  In training the model calls ``gather``
  inside the block's ``torch.utils.checkpoint``, so the recompute gathers
  again and the backward reduce-scatters each block's gradient to the
  stored shards' placements before the next block's backward.

The model-axis recuts live here too (all-to-alls, never a whole gather):
a dense FFN stacked over a multiple of the axis's size, which the
reference's rule cuts by its block dimension (reading ``[nb, d, d_ff]`` as
stacked experts), is moved to one block's cut; a Mamba leaf is moved to its
``d_inner`` channels (``policy.compute_cut``)."""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import ctx
from repro_torch.sharding.policy import (P, ShardingPolicy, keystr_path, mesh_axis_sizes,
                                         placements, tree_map_with_path)

# the block gathers made, forward and recompute (``BlockShards.gather``)
COUNTS = {"blocks": 0}
BLOCK_ROOTS = ("layers", "enc_layers")


def is_placed(tree) -> bool:
    """Whether the first leaf of ``tree`` is a DTensor stored on a mesh with
    data axes (the placed layout), not one on the model sub-mesh the
    blocks compute on."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return isinstance(tree, DTensor) and tuple(tree.device_mesh.mesh_dim_names or ()) != (
        "model",)


def gather_model_shards(tree, mesh, cut: tuple[str, ...] = ()):
    """Every DTensor of ``tree`` gathered over the data axes only, its
    ``model``-axis shard rewrapped as a DTensor on the 1-D model sub-mesh
    (``mesh["model"]``) with its placement there: what the tensor-parallel
    blocks take (a collective: every rank calls it).  A stacked leaf the
    policy cuts over the model axis by its block dimension (a dense FFN
    ``[nb, d, d_ff]``, which the reference's rule reads as stacked experts)
    is recut there as one block's weight is (``param_spec`` of its
    ``[d, d_ff]``; an all-to-all over the model axis after the gather), so
    each block's product is tensor-parallel.  A leaf that the policy
    computes cut otherwise than it stores it (``policy.compute_cut``: a
    Mamba leaf, by its ``d_inner`` channels) is recut so: ``in_proj``
    ``[nb, d, 2·di]``, cut contiguously, so the rank holds the ``x`` and
    ``z`` columns of its own channels (an all-to-all of pieces,
    :class:`_Regroup`; its DTensor's global layout is then the ranks'
    pieces in rank order, not the parameter's), ``x_proj`` from its output
    to its input dimension (an all-to-all), and the leaves that arrive
    whole (``conv_b``; ``D``, whose rule reads the block dimension) sliced
    on each rank.  Gradients flow back through
    ``to_local`` as ``Partial`` over the data axes in ``cut`` (the axes the
    batch is cut over) and in the model-axis placement used (``Partial``
    for a sliced leaf); the reduce-scatter back to the parameter's
    placements is DTensor's.  Any other leaf as it is."""
    names = list(mesh_axis_sizes(mesh))
    m = names.index("model")
    tp_mesh = mesh["model"]
    n = tp_mesh.size()
    policy = ShardingPolicy(mesh, None)

    def one(path, x):
        if not isinstance(x, DTensor):
            return x
        pl = x.placements[m]
        cut_to = policy.compute_cut(keystr_path(path), tuple(x.shape))
        sliced = cut_to is not None and pl == Replicate()
        pls = [pl if i == m else Replicate() for i in range(len(names))]
        grad = [(Partial() if sliced else pl) if i == m else Partial() if a in cut
                else Replicate() for i, a in enumerate(names)]
        shard = x.redistribute(mesh, pls).to_local(grad_placements=grad)
        if pl == Shard(0) and x.dim() >= 2 and path[0] in BLOCK_ROOTS:
            # recut after the gather over the data axes, on the model axis
            # alone: DTensor would gather the whole leaf on the way
            shard, pl = _recut_blocks(shard, pl, policy, keystr_path(path), x.shape, tp_mesh)
        if cut_to is not None:
            shard, pl = _recut_runs(shard, pl, *cut_to, tp_mesh), Shard(cut_to[0])
        return DTensor.from_local(shard, tp_mesh, [pl], run_check=False)
    return tree_map_with_path(one, tree)


def gather_outside_blocks(params: dict) -> dict:
    """``params`` (placed) with every leaf outside the stacked blocks
    gathered (:func:`gather_model_shards`, the gradients ``Partial`` over the
    data axes the batch is cut over, ``ctx.cut_batch``); the blocks' trees
    as they are."""
    outside = {k: v for k, v in params.items() if k not in BLOCK_ROOTS}
    mesh = _first(outside).device_mesh
    return {**params, **gather_model_shards(outside, mesh, ctx.batch_axes())}


def _first(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _recut_blocks(shard: torch.Tensor, pl, policy: ShardingPolicy, path: str, shape,
                  tp_mesh):
    """A stacked leaf's shard cut by its block dimension on the model axis
    (``pl`` ``Shard(0)``) → cut as one block's weight is (``param_spec`` of
    the block's shape, one dimension down): an all-to-all on the model axis
    where that is a cut (with one rank, the shard is the leaf), the stack
    gathered over the axis where it is whole.  Returns (shard, placement)."""
    spec = policy.param_spec(path, tuple(shape[1:]))
    pl = placements(policy.mesh, P(None, *spec))[list(mesh_axis_sizes(policy.mesh)).index(
        "model")]
    if isinstance(pl, Shard):
        if tp_mesh.size() > 1:
            shard = _Recut.apply(shard, 0, pl.dim, tp_mesh.get_group())
        return shard, pl
    return DTensor.from_local(shard, tp_mesh, [Shard(0)], run_check=False).redistribute(
        tp_mesh, [pl]).to_local(), pl


@dataclasses.dataclass(frozen=True)
class _Plan:
    """How one stacked leaf's block is gathered: ``cuts``, the data axes
    that cut it as (process group, the block's dimension, whether the
    batch is cut over the axis too), the minor axis first; ``sums``, the
    groups its gradient is summed over besides (a data axis the batch is
    cut over that does not cut the leaf; the model axis for a whole leaf
    sliced to its channels); its placement on the model sub-mesh; a
    compute cut ``(dim, runs)`` in the block's dimensions, or None."""
    cuts: tuple
    sums: tuple
    model: object
    runs: tuple | None


class _GatherData(torch.autograd.Function):
    """A block leaf's stored shard made whole over the data axes that cut
    it (an all-gather an axis, the minor axis first, as the stored shard's
    chunks nest); each model rank gathers its own model-axis shard.  The
    backward returns the gathered gradient to the shard: reduce-scattered
    over an axis the batch is cut over (each rank's rows' share), sliced
    over one it is not (every rank holds the whole), then summed over
    ``sums`` (all-reduces)."""

    @staticmethod
    def forward(ctx_, x, cuts: tuple, sums: tuple):
        ctx_.cuts, ctx_.sums = cuts, sums
        for group, dim, _ in cuts:
            x = _all_gather(x, dim, group)
        return x

    @staticmethod
    def backward(ctx_, grad):
        for group, dim, summed in reversed(ctx_.cuts):
            grad = _reduce_scatter(grad, dim, group) if summed else grad.chunk(
                dist.get_world_size(group), dim)[dist.get_rank(group)]
        grad = grad.contiguous()
        for group in ctx_.sums:
            dist.all_reduce(grad, group=group)
        return grad, None, None


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' parts of ``group`` joined along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.unflatten(0, (n, -1)).movedim(0, dim).flatten(dim, dim + 1)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over ``group``, this rank's chunk of ``dim`` kept."""
    n = dist.get_world_size(group)
    parts = x.unflatten(dim, (n, -1)).movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, parts.flatten(0, 1), group=group)
    return out


class BlockShards:
    """The stacked leaves of a placed ``layers`` (or ``enc_layers``) tree
    under ``root``, split into each block's stored shards: ``shards(b)`` is
    block ``b``'s tree of plain tensors, views taken by one ``unbind`` a
    leaf, so a backward stacks each leaf's gradient once.  A leaf the policy
    cuts by its block dimension on the model axis is recut first, on the
    stored shard (:func:`_recut_blocks`: one all-to-all a leaf, its
    gradient moved back once), so a block's d_ff columns on a model rank
    interleave over the data ranks' pieces alike in ``gate``, ``up`` and
    ``down``; a block is never taken from a DTensor (slicing a DTensor on a
    cut dimension gathers the whole leaf).

    ``gather(shards)`` makes one block's tree as the tensor-parallel blocks
    take it: each leaf gathered over the data axes (its gradient
    reduce-scattered back over the axes the batch is cut over, read from
    ``ctx.cut_batch`` when the shards are taken), recut to its compute cut
    (``policy.compute_cut``, a Mamba leaf) and wrapped on the model
    sub-mesh.  A collective: every rank gathers the same blocks in the same
    order."""

    def __init__(self, layers: dict, root: str = "layers"):
        mesh = _first(layers).device_mesh
        names = list(mesh_axis_sizes(mesh))
        m = names.index("model")
        self.mesh, self.tp_mesh = mesh, mesh["model"]
        policy = ShardingPolicy(mesh, None)
        cut = ctx.batch_axes()
        parts: list = []

        def plan(path, x):
            key = keystr_path((root, *path))
            pl = x.placements[m]
            local = x.to_local()
            if pl == Shard(0):
                if x.dim() < 2:
                    raise ValueError(f"{key}: a 1-D stacked leaf cut by blocks")
                local, pl = _recut_blocks(local, pl, policy, key, x.shape, self.tp_mesh)
            cut_to = policy.compute_cut(key, tuple(x.shape))
            cuts, sums = [], []
            for i in reversed(range(len(names))):
                p, group = x.placements[i], mesh.get_group(i)
                if i == m or mesh.size(i) == 1:
                    continue
                if p == Shard(0):
                    raise ValueError(f"{key}: cut by blocks over the data axes")
                if isinstance(p, Shard):
                    cuts.append((group, p.dim - 1, names[i] in cut))
                elif names[i] in cut:
                    sums.append(group)
            if cut_to is not None and pl == Replicate() and mesh.size(m) > 1:
                sums.append(mesh.get_group(m))      # each rank sliced its channels
            parts.append(local.unbind(0))
            return _Plan(tuple(cuts), tuple(sums),
                         Shard(pl.dim - 1) if isinstance(pl, Shard) else pl,
                         None if cut_to is None else (cut_to[0] - 1, cut_to[1]))
        self._plans = tree_map_with_path(plan, layers)
        self._parts = parts

    def shards(self, b: int) -> dict:
        """Block ``b``'s stored shards, plain tensors in the tree's shape."""
        it = iter(self._parts)
        return _map(lambda _: next(it)[b], self._plans)

    def gather(self, shards: dict) -> dict:
        """One block's tree (``shards(b)``) gathered: DTensors on the model
        sub-mesh, each leaf its model-axis shard whole over the data axes."""
        COUNTS["blocks"] += 1

        def one(plan: _Plan, s: torch.Tensor):
            g = _GatherData.apply(s, plan.cuts, plan.sums) if plan.cuts or plan.sums else s
            model = plan.model
            if plan.runs is not None:
                g, model = _recut_runs(g, model, *plan.runs, self.tp_mesh), Shard(plan.runs[0])
            return DTensor.from_local(g, self.tp_mesh, [model], run_check=False)
        return _zip(one, self._plans, shards)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _recut_runs(shard: torch.Tensor, pl, dim: int, runs: int, tp_mesh) -> torch.Tensor:
    """A leaf's model-axis shard with placement ``pl`` → rank r's chunk r
    of each of the ``runs`` equal runs of dimension ``dim``, joined: a whole
    leaf sliced, one cut on another dimension recut (an all-to-all), a
    contiguous cut of several runs regrouped (:class:`_Regroup`)."""
    n, group = tp_mesh.size(), tp_mesh.get_group()
    if pl == Replicate():
        k = shard.shape[dim] // (runs * n)
        return shard.unflatten(dim, (runs, -1)).narrow(
            dim + 1, tp_mesh.get_local_rank() * k, k).flatten(dim, dim + 1)
    if n > 1 and pl != Shard(dim):
        shard = _Recut.apply(shard, pl.dim, dim, group)
    if n > 1 and runs > 1:
        shard = _Regroup.apply(shard, dim, runs, group)
    return shard


def _all_to_all(x: torch.Tensor, a: int, b: int, group) -> torch.Tensor:
    """A rank's part of a tensor cut over ``group``'s n ranks by dimension
    ``a`` → its part cut by dimension ``b`` instead: chunk ``j`` of ``x``
    along ``b`` goes to rank ``j``, and what the ranks send back is joined
    along ``a`` in rank order."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=b))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=a)


class _Recut(torch.autograd.Function):
    """A shard moved from one cut dimension to another over a process group
    (an all-to-all); the backward moves the gradient back."""

    @staticmethod
    def forward(ctx_, x, a: int, b: int, group):
        ctx_.cut = (a, b, group)
        return _all_to_all(x, a, b, group)

    @staticmethod
    def backward(ctx_, grad):
        a, b, group = ctx_.cut
        return _all_to_all(grad.contiguous(), b, a, group), None, None, None


def _regroup(x: torch.Tensor, dim: int, k: int, group, back: bool) -> torch.Tensor:
    """Rank s's part of dimension ``dim``, pieces ``s·k … s·k+k−1`` of a
    contiguous cut into n·k, → pieces ``t, t+n, …, t+(k−1)·n`` on rank t
    (``back``: the reverse).  With k ≤ n each piece goes to a rank of its
    own and each rank sends and receives k pieces: one all-to-all."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    to = [(r * k + i) % n for i in range(k)]            # where my pieces go
    src = [(r + j * n) // k for j in range(k)]          # where my new ones are
    if back:
        to, src = src, to
    pieces = x.unflatten(dim, (k, -1)).movedim(dim, 0)
    send = pieces[sorted(range(k), key=to.__getitem__)]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, [src.count(a) for a in range(n)],
                           [to.count(a) for a in range(n)], group=group)
    out = torch.empty_like(recv)
    out[sorted(range(k), key=src.__getitem__)] = recv   # arrived in source order
    return out.movedim(0, dim).flatten(dim, dim + 1)


class _Regroup(torch.autograd.Function):
    """``_regroup``: ``in_proj``'s ``[x | z]`` output columns cut by the
    policy → the x and z columns of the rank's channels (k = 2).  The
    backward moves the gradient back."""

    @staticmethod
    def forward(ctx_, x, dim: int, k: int, group):
        ctx_.args = (dim, k, group)
        return _regroup(x, dim, k, group, False)

    @staticmethod
    def backward(ctx_, grad):
        return _regroup(grad.contiguous(), *ctx_.args, True), None, None, None
