"""Optimizers with the reference's formulas (``repro/train/optimizer.py``).

Two forms of Adam / AdamW, both with the reference's update

    m ← b1·m + (1−b1)·g          v ← b2·v + (1−b2)·g²
    u = (m/c1) / (sqrt(v/c2) + eps),   c1 = 1 − b1^t,  c2 = 1 − b2^t

(``torch.optim.Adam`` places ``eps`` differently and keeps one step count
for all lanes, so it is not used):

* the fleet form (``Optimizer``, ``adamw``, ``adam``, ``apply_updates``),
  which the DRL agents use: parameters are lists of tensors carrying the
  fleet axis ``[F, ...]``, ``step`` is ``[F]`` and weight decay falls on
  the per-lane matrices (``p.dim() >= 3``);
* the tree form (``TreeOptimizer``, ``tree_adamw``, ``tree_adam``,
  ``sgd``, ``apply_tree_updates``), which the LM trainer uses: parameters
  are nested dicts of tensors, as the reference's pytrees, ``step`` is one
  int32 scalar and weight decay falls on every leaf with ``ndim >= 2``.
  Moments take the dtype they were initialized in, and the arithmetic
  promotes as the reference's does leaf for leaf: a bfloat16 moment is
  updated in bfloat16 (the gradient cast to it), and ``u`` is float32.

``clip_by_global_norm``, ``warmup_cosine`` and ``constant_schedule`` work
on the tree form; a schedule takes the step as a tensor and returns a
float32 scalar on the step's device."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor            # [F] int32
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # decoupled weight decay on per-lane matrices (ndim >= 2 per lane)
    weight_decay: float = 0.0

    def init(self, params: list[torch.Tensor]) -> AdamState:
        fleet = params[0].shape[0]
        return AdamState(
            step=torch.zeros(fleet, dtype=torch.int32, device=params[0].device),
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
        )

    @torch.no_grad()
    def update(self, grads, state: AdamState, params):
        """(updates, new state) for ``grads``; nothing is written in place."""
        b1, b2 = self.b1, self.b2
        step = state.step + 1
        t = step.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        mu = [b1 * m + (1 - b1) * g for m, g in zip(state.mu, grads)]
        nu = [b2 * v + (1 - b2) * torch.square(g) for v, g in zip(state.nu, grads)]
        updates = []
        for m, v, p in zip(mu, nu, params):
            shape = (-1,) + (1,) * (p.dim() - 1)
            u = (m / c1.view(shape)) / (torch.sqrt(v / c2.view(shape)) + self.eps)
            if self.weight_decay and p.dim() >= 3:
                u = u + self.weight_decay * p
            updates.append(-self.learning_rate * u)
        return updates, AdamState(step=step, mu=mu, nu=nu)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    return Optimizer(learning_rate, b1, b2, eps, weight_decay)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return Optimizer(learning_rate, b1, b2, eps, 0.0)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """``p ← p + u`` in place."""
    for p, u in zip(params, updates):
        p.add_(u)


# ===========================================================================
# The tree form (the reference's pytree optimizers)
# ===========================================================================
def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (the others' leaves beside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in the reference's order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return next(it)
    return build(tree)


class TreeAdamState(NamedTuple):
    step: torch.Tensor            # int32 scalar
    mu: Any
    nu: Any


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


@dataclasses.dataclass(frozen=True)
class TreeOptimizer:
    init: Callable                # params -> state
    update: Callable              # (grads, state, params) -> (updates, state)


Schedule = Callable[[torch.Tensor], torch.Tensor]


def _lr_at(learning_rate: float | Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(learning_rate):
        return learning_rate(step)
    return torch.tensor(learning_rate, dtype=torch.float32, device=step.device)


def _tree_zeros_like(tree, dtype=torch.float32):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device), tree)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def tree_adamw(learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0,
               mask: Callable | None = None) -> TreeOptimizer:
    """The reference's ``adamw``: ``mask(params)`` gives a tree of bools
    (default ``p.dim() >= 2``) for the decay.  Moments start float32;
    recast them for another moment dtype (``trainer.init_train_state``)."""

    def init(params) -> TreeAdamState:
        return TreeAdamState(_step0(params), _tree_zeros_like(params),
                             _tree_zeros_like(params))

    @torch.no_grad()
    def update(grads, state: TreeAdamState, params):
        step = state.step + 1
        lr = _lr_at(learning_rate, step)
        t = step.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(v.dtype)),
                      state.nu, grads)
        decay = (mask(params) if mask is not None
                 else tree_map(lambda p: p.dim() >= 2, params))

        def upd(m, v, p, dm):
            # a bfloat16 moment over the float32 c1, c2 promotes to float32
            u = (m.float() / c1) / (torch.sqrt(v.float() / c2) + eps)
            if weight_decay and dm:
                u = u + weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        updates = tree_map(upd, mu, nu, params, decay)
        return updates, TreeAdamState(step, mu, nu)

    return TreeOptimizer(init, update)


def tree_adam(learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> TreeOptimizer:
    return tree_adamw(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def sgd(learning_rate: float | Schedule, momentum: float = 0.0) -> TreeOptimizer:
    def init(params) -> SGDState:
        return SGDState(_step0(params), _tree_zeros_like(params))

    @torch.no_grad()
    def update(grads, state: SGDState, params):
        step = state.step + 1
        lr = _lr_at(learning_rate, step)
        mom = tree_map(lambda m, g: momentum * m + g.to(m.dtype), state.momentum, grads)
        updates = tree_map(lambda m, p: (-lr * m).to(p.dtype), mom, params)
        return updates, SGDState(step, mom)

    return TreeOptimizer(init, update)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, leaf_sum=None):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before), the norm a float32 scalar summed over the leaves in the
    reference's order.  ``leaf_sum(sums)`` takes the list of each leaf's
    local sum of squares to the whole leaves' (a sharded state's: summed
    over the ranks that hold the leaf's other shards, a replicated leaf
    counted once)."""
    sums = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    if leaf_sum is not None:
        sums = leaf_sum(sums)
    gnorm = torch.sqrt(sum(sums))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


@torch.no_grad()
def apply_tree_updates(params, updates):
    """``p + u`` in ``p``'s dtype, a new tree (the reference's
    ``apply_updates``)."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Schedule:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)
