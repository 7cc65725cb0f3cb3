"""Training step: microbatched gradient accumulation and AdamW
(``repro/train/trainer.py``).

``make_train_step`` builds the step ``launch/train.py`` runs:

  batch [B_global, S]  ->  split [n_micro, B_micro, S]
  a loop over the microbatches: the loss and its gradient (each block
  rematerialized, ``lm.train_loss``), summed in ``accum_dtype``
  (optional) int8 error-feedback compression of the mean gradient
  global-norm clip -> AdamW update (moments in ``moment_dtype``)

The state lives on one device (the card by default), its step counters
there too, so a step makes no device round trip; the metrics are device
scalars the caller reads when it wants them.  Nothing is compiled, so the
reference's ``jitted_train_step`` becomes ``cached_train_step``, one step
function per (cfg, setup, mesh).  The step is functional, as the
reference's: it returns a new state and leaves the one it was given as it
was.

Over a mesh (a ``DeviceMesh`` from ``launch.mesh.make_production_mesh``)
the state is the reference dry-run's layout (``shard_train_state``): the
parameters, AdamW's moments and the per-leaf EF residuals are DTensors
with their parameter's placements under the sharding policy, the scalars
replicated, and each rank stores only its shards.  ``make_train_step(cfg,
setup, mesh)`` then

  takes this rank's rows of each microbatch (``policy.batch_spec``: cut
    over the data axes, replicated when they do not divide it);
  runs the loss on the placed tree under ``ctx.use_mesh``: the model
    gathers the leaves outside the blocks once (the embedding,
    ``lm_head``, the final norms) and each block's leaves just before the
    block, inside its rematerialized checkpoint, so the recompute gathers
    them again (``sharding/gather.py``); each leaf over the data axes only,
    its ``model``-axis shard handed to the block as a DTensor on the model
    sub-mesh, so the blocks compute tensor-parallel on DTensor activations
    (``sharding/ctx.py``): column- and row-parallel products, the kernels
    on each rank's heads, a vocab-parallel embedding and cross-entropy;
  takes each gradient back on its parameter's placements: a block's
    leaves reduce-scattered in that block's backward (``Partial`` over the
    data axes when the batch is cut: each rank's share of the global
    batch's mean loss, ``sharding.ctx.batch_sum``);
  compresses (EF-int8, the scale over the whole leaf), clips (the global
    norm, a replicated leaf counted once) and updates each rank's shards.

One block's gathered leaves are live at a time beside the rank's shards,
as in the reference's rematerialized scan.  The MoE FFN is cut by experts
or by each expert's d_ff, and the Mamba mixer by ``d_inner``: its leaves
are recut to the rank's channels on the model axis, one block at a time.
:func:`gather_model_shards` (``sharding/gather.py``) gathers a whole tree
so, for a caller that wants one."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import ctx
from repro_torch.sharding.gather import gather_model_shards  # noqa: F401  (the trainer's name)
from repro_torch.sharding.policy import ShardingPolicy, mesh_axis_sizes
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.compression import ef_compress_grads

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    micro_batches: int = 4
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"       # "bfloat16" halves optimizer memory
    accum_dtype: str = "float32"
    compress_grads: bool = False        # int8 EF (train/compression)
    b1: float = 0.9
    b2: float = 0.95


class TrainState(NamedTuple):
    step: torch.Tensor                  # int32 scalar
    params: Any
    opt: opt_lib.TreeAdamState
    # error-feedback residual for gradient compression (scalar zeros if unused)
    ef_residual: Any


def make_optimizer(setup: TrainSetup) -> opt_lib.TreeOptimizer:
    sched = opt_lib.warmup_cosine(setup.learning_rate, setup.warmup_steps,
                                  setup.total_steps)
    return opt_lib.tree_adamw(sched, b1=setup.b1, b2=setup.b2,
                              weight_decay=setup.weight_decay)


def init_train_state(cfg: ModelConfig, setup: TrainSetup, gen: torch.Generator | None,
                     device: str | torch.device | None = None) -> TrainState:
    """Parameters drawn from ``gen`` (on ``device``; default CUDA, raises
    without a GPU) and a fresh optimizer state."""
    device = resolve_device(device)
    return finish_init(lm.init_params(cfg, gen, device), setup)


def finish_init(params, setup: TrainSetup) -> TrainState:
    """The train state of step 0 around ``params``: AdamW moments in
    ``moment_dtype``, the error-feedback residuals bfloat16 (one per leaf
    with compression, scalars without), as the reference's."""
    st = make_optimizer(setup).init(params)
    mdt = DTYPES[setup.moment_dtype]
    opt = opt_lib.TreeAdamState(st.step, opt_lib.tree_map(lambda m: m.to(mdt), st.mu),
                                opt_lib.tree_map(lambda v: v.to(mdt), st.nu))
    shape = (lambda p: p.shape) if setup.compress_grads else (lambda p: ())
    ef = opt_lib.tree_map(
        lambda p: torch.zeros(shape(p), dtype=torch.bfloat16, device=p.device), params)
    return TrainState(torch.zeros((), dtype=torch.int32, device=st.step.device),
                      params, opt, ef)


def abstract_train_state(cfg: ModelConfig, setup: TrainSetup) -> TrainState:
    """The full train state's shapes and dtypes on the ``meta`` device: no
    memory is allocated and nothing is drawn."""
    return finish_init(lm.init_params(cfg, None, "meta"), setup)


@functools.lru_cache(maxsize=None)
def cached_train_step(cfg: ModelConfig, setup: TrainSetup, mesh=None) -> Callable:
    """One step function per (cfg, setup, mesh)."""
    return make_train_step(cfg, setup, mesh)


def make_train_step(cfg: ModelConfig, setup: TrainSetup, mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (new state, {"loss", "grad_norm",
    "lr"}).  ``batch`` holds ``[B, ...]`` tensors on the state's device
    (``tokens``, ``targets``, and a vlm's ``frontend_embeds`` or an
    encdec's ``frames``), B a multiple of ``setup.micro_batches``.  With a
    ``mesh`` the state is ``shard_train_state``'s and ``batch`` the global
    batch, the same on every rank (the module docstring)."""
    if mesh is not None:
        return _make_meshed_train_step(cfg, setup, mesh)
    loss_fn = lm.train_loss(cfg)
    optz = make_optimizer(setup)
    sched = opt_lib.warmup_cosine(setup.learning_rate, setup.warmup_steps,
                                  setup.total_steps)
    adt = DTYPES[setup.accum_dtype]
    n_micro = setup.micro_batches

    def train_step(state: TrainState, batch: dict):
        micro = _microbatches(batch, n_micro)
        params = opt_lib.tree_map(lambda p: p.detach().requires_grad_(), state.params)
        leaves = opt_lib.tree_leaves(params)
        grads = opt_lib.tree_map(
            lambda p: torch.zeros(p.shape, dtype=adt, device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n_micro):
            loss, _ = loss_fn(params, {name: xs[i] for name, xs in micro.items()})
            micro_grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for a, g in zip(opt_lib.tree_leaves(grads), micro_grads):
                if g is not None:
                    a.add_(g.to(adt))
            loss_sum = loss_sum + loss.detach()
        grads = opt_lib.tree_map(lambda a: a.div_(n_micro), grads)
        loss = loss_sum / n_micro

        ef = state.ef_residual
        if setup.compress_grads:
            grads, ef = ef_compress_grads(grads, ef)

        grads, gnorm = opt_lib.clip_by_global_norm(grads, setup.clip_norm)
        updates, opt_state = optz.update(grads, state.opt, state.params)
        new_params = opt_lib.apply_tree_updates(state.params, updates)
        step = state.step + 1
        new_state = TrainState(step, new_params, opt_state, ef)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": sched(step)}

    return train_step



def _microbatches(batch: dict, n_micro: int) -> dict:
    for name, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {name} has {x.shape[0]} rows, not a multiple "
                             f"of {n_micro} microbatches")
    return {name: x.chunk(n_micro) for name, x in batch.items()}


# ===========================================================================
# The train state and step over a mesh
# ===========================================================================
def shard_train_state(state: TrainState, policy: ShardingPolicy) -> TrainState:
    """``state`` (the same full tensors on every rank) as DTensors on
    ``policy.mesh``: parameters, moments and per-leaf EF residuals with the
    parameter's placements, the step counters and scalar residuals
    replicated.  Each rank keeps only its shards."""
    mesh = policy.mesh
    placed = policy.params_sharding(state.params)
    rep = policy.replicated()

    def put(x, pl):
        return distribute_tensor(x.detach(), mesh, pl if x.dim() else rep)

    tree = lambda t: opt_lib.tree_map(put, t, placed)  # noqa: E731
    return TrainState(distribute_tensor(state.step, mesh, rep), tree(state.params),
                      opt_lib.TreeAdamState(distribute_tensor(state.opt.step, mesh, rep),
                                            tree(state.opt.mu), tree(state.opt.nu)),
                      tree(state.ef_residual))


def unshard_train_state(state: TrainState) -> TrainState:
    """Every DTensor of ``state`` gathered whole on every rank (a collective:
    every rank calls it), as plain tensors: the unmeshed layout."""
    def whole(x):
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim).to_local()
    return TrainState(whole(state.step), opt_lib.tree_map(whole, state.params),
                      opt_lib.TreeAdamState(whole(state.opt.step),
                                            opt_lib.tree_map(whole, state.opt.mu),
                                            opt_lib.tree_map(whole, state.opt.nu)),
                      opt_lib.tree_map(whole, state.ef_residual))


def _local_rows(policy: ShardingPolicy, rows: int) -> tuple[slice, tuple[str, ...]]:
    """(this rank's rows of a ``rows``-row batch, the mesh axes they are cut
    over): cut over the data axes, major first, when ``policy.batch_spec``
    cuts it; all rows and no axes when it is replicated."""
    if policy.batch_spec(rows)[0] is None:
        return slice(None), ()
    names = list(mesh_axis_sizes(policy.mesh))
    coord = policy.mesh.get_coordinate()
    idx = 0
    for a in policy.axes.dp:
        idx = idx * policy.mesh.size(names.index(a)) + coord[names.index(a)]
    n = rows // policy.dp_size
    return slice(idx * n, (idx + 1) * n), policy.axes.dp


def cache_model_shards(cache: dict, mesh) -> dict:
    """A decode cache placed on ``mesh`` by ``policy.cache_sharding`` (its
    rows cut over the data axes where they divide the batch), each leaf's
    local shard rewrapped as a DTensor on the 1-D model sub-mesh
    (``mesh["model"]``) with its model-axis placement there: K/V cut by kv
    heads or by positions, the RWKV state by heads, the Mamba state by
    ``d_inner``, the rest whole.  No collective and no copy: the new leaves
    share the shards' storage, so the tensor-parallel ``lm.serve_step``
    updates the placed cache in place.  ``len`` and any other plain value
    as it is, in a new dict."""
    m = list(mesh_axis_sizes(mesh)).index("model")
    tp_mesh = mesh["model"]

    def one(x):
        if not isinstance(x, DTensor):
            return x
        return DTensor.from_local(x.to_local(), tp_mesh, [x.placements[m]], run_check=False)
    return opt_lib.tree_map(one, cache)


def _leaf_reduce(mesh, placements: list, op):
    """``reduce(values)``: each leaf's scalar over its own shard (in
    ``tree_leaves`` order) → over the whole leaf: ``op`` over the mesh
    dimensions that shard it, one collective a dimension for all the leaves
    sharded alike; a replicated dimension is not reduced (its ranks hold
    the same values)."""
    dims = [tuple(i for i, pl in enumerate(pls) if isinstance(pl, Shard)
                  and mesh.size(i) > 1) for pls in placements]

    def reduce(values: list) -> list:
        out = list(values)
        groups: dict = {}
        for i, d in enumerate(dims):
            if d:
                groups.setdefault(d, []).append(i)
        for d, idx in groups.items():
            stacked = torch.stack([values[i] for i in idx])
            for m in d:
                dist.all_reduce(stacked, op=op, group=mesh.get_group(m))
            for j, i in enumerate(idx):
                out[i] = stacked[j]
        return out
    return reduce


def _make_meshed_train_step(cfg: ModelConfig, setup: TrainSetup, mesh) -> Callable:
    loss_fn = lm.train_loss(cfg)
    optz = make_optimizer(setup)
    sched = opt_lib.warmup_cosine(setup.learning_rate, setup.warmup_steps,
                                  setup.total_steps)
    adt = DTYPES[setup.accum_dtype]
    n_micro = setup.micro_batches
    policy = ShardingPolicy(mesh, cfg)

    def local(tree):
        return opt_lib.tree_map(lambda x: x.to_local(), tree)

    def placed(tree, like):
        return opt_lib.tree_map(lambda x, d: DTensor.from_local(
            x, mesh, d.placements, run_check=False), tree, like)

    def train_step(state: TrainState, batch: dict):
        micro = _microbatches(batch, n_micro)
        rows, cut = _local_rows(policy, next(iter(batch.values())).shape[0] // n_micro)
        params = opt_lib.tree_map(lambda p: p.detach().requires_grad_(), state.params)
        leaves = opt_lib.tree_leaves(params)
        grads = opt_lib.tree_map(
            lambda p: torch.zeros(p.to_local().shape, dtype=adt, device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        with ctx.use_mesh(mesh), ctx.cut_batch(cut):
            for i in range(n_micro):
                loss, _ = loss_fn(params, {name: xs[i][rows] for name, xs in micro.items()})
                micro_grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                for a, g, p in zip(opt_lib.tree_leaves(grads), micro_grads, leaves):
                    if g is None:
                        continue
                    if g.placements != p.placements:    # each gather's backward places it
                        raise AssertionError(f"a gradient on {g.placements}, its parameter "
                                             f"on {p.placements}")
                    a.add_(g.to_local().to(adt))
                loss_sum = loss_sum + loss.detach()
        grads = opt_lib.tree_map(lambda a: a.div_(n_micro), grads)
        loss = loss_sum / n_micro

        shards = [p.placements for p in leaves]
        ef = local(state.ef_residual)
        if setup.compress_grads:
            grads, ef = ef_compress_grads(grads, ef, leaf_max=_leaf_reduce(
                mesh, shards, dist.ReduceOp.MAX))
        grads, gnorm = opt_lib.clip_by_global_norm(
            grads, setup.clip_norm, leaf_sum=_leaf_reduce(mesh, shards, dist.ReduceOp.SUM))
        opt_in = opt_lib.TreeAdamState(state.opt.step.to_local(), local(state.opt.mu),
                                       local(state.opt.nu))
        params_l = local(state.params)
        updates, opt_state = optz.update(grads, opt_in, params_l)
        new_params = opt_lib.apply_tree_updates(params_l, updates)
        step = state.step.to_local() + 1
        new_state = TrainState(
            DTensor.from_local(step, mesh, state.step.placements, run_check=False),
            placed(new_params, state.params),
            opt_lib.TreeAdamState(
                DTensor.from_local(opt_state.step, mesh, state.opt.step.placements,
                                   run_check=False),
                placed(opt_state.mu, state.opt.mu), placed(opt_state.nu, state.opt.nu)),
            placed(ef, state.ef_residual))
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": sched(step)}

    return train_step
