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
function per (cfg, setup).  The step is functional, as the reference's:
it returns a new state and leaves the one it was given as it was."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
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
def cached_train_step(cfg: ModelConfig, setup: TrainSetup) -> Callable:
    """One step function per (cfg, setup)."""
    return make_train_step(cfg, setup)


def make_train_step(cfg: ModelConfig, setup: TrainSetup) -> Callable:
    """Returns train_step(state, batch) -> (new state, {"loss", "grad_norm",
    "lr"}).  ``batch`` holds ``[B, ...]`` tensors on the state's device
    (``tokens``, ``targets``, and a vlm's ``frontend_embeds`` or an
    encdec's ``frames``), B a multiple of ``setup.micro_batches``."""
    loss_fn = lm.train_loss(cfg)
    optz = make_optimizer(setup)
    sched = opt_lib.warmup_cosine(setup.learning_rate, setup.warmup_steps,
                                  setup.total_steps)
    adt = DTYPES[setup.accum_dtype]
    n_micro = setup.micro_batches

    def train_step(state: TrainState, batch: dict):
        for name, x in batch.items():
            if x.shape[0] % n_micro:
                raise ValueError(f"batch {name} has {x.shape[0]} rows, not a multiple "
                                 f"of {n_micro} microbatches")
        micro = {name: x.chunk(n_micro) for name, x in batch.items()}
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

