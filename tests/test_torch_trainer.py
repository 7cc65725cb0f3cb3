"""The port's train step (``repro_torch/train/trainer.py``) against the
reference's (``repro/train/trainer.py``): one step from the reference's
own ``TrainState`` carried across (``convert.train_state_from_numpy``),
after two reference steps so the moments are not zero, with float32
moments, with bfloat16 moments and with int8 error-feedback
compression, on float32 smoke configs; microbatch accumulation; the
state's layout; and the reference's trainer tests' twins (the loss falls
on a memorized batch, compressed training still learns).  Every draw comes
from a fixed numpy seed.

The step's parameters, moments and residuals are held leaf by leaf within
a share of the leaf's largest magnitude: 1e-5 in float32, two bfloat16
steps (2**-7) for a bfloat16 moment or residual (XLA may keep bfloat16
expressions in float32 where torch rounds each operation), and with
bfloat16 moments a parameter also within 4·2**-7 times the learning rate
(the moments' rounding, carried into the update); the loss, the gradient
norm and the learning rate at 1e-5 relative."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import to_numpy, torch
from torch_lm_cases import train_batch

from repro.configs import get_config as jax_get_config
from repro.train import trainer as jtrainer
from repro_torch.checkpoint.checkpointer import named_leaves
from repro_torch.configs import get_config
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.train import trainer
from repro_torch.train.optimizer import tree_leaves

BF16_STEP = 2.0 ** -7
SETUPS = {
    "f32_moments": dict(),
    "bf16_moments": dict(moment_dtype="bfloat16"),
    "compressed": dict(compress_grads=True),
}


def _cfgs(arch: str):
    return (dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True), dtype="float32"))


def _setup(module, **kw):
    return module.TrainSetup(**{**dict(micro_batches=2, learning_rate=1e-2,
                                       warmup_steps=2, total_steps=20), **kw})


def _batches(cfg, n: int, seed: int):
    return [train_batch(cfg, 4, 16, seed=seed + i) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, variant: str):
    """The reference's state after two steps, its third step's state and
    metrics, all as numpy trees, and the third batch."""
    jcfg, tcfg = _cfgs(arch)
    setup = _setup(jtrainer, **SETUPS[variant])
    state = jtrainer.init_train_state(jcfg, setup, jax.random.PRNGKey(0))
    step = jax.jit(jtrainer.make_train_step(jcfg, setup))
    b0, b1, b2 = _batches(tcfg, 3, seed=100)
    for b in (b0, b1):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    before = jax.tree.map(np.asarray, state)
    after, metrics = step(state, {k: jnp.asarray(v) for k, v in b2.items()})
    return (before, jax.tree.map(np.asarray, after),
            jax.tree.map(np.asarray, metrics), b2)


def _assert_state(got, want, scaled: float, param_atol: float = 0.0):
    """``got`` (the port's TrainState) against ``want`` (the reference's,
    numpy) leaf by leaf, in the checkpoint's names and order; a float32
    parameter also within ``param_atol``."""
    want_leaves = jax.tree.leaves(want)
    got_named = named_leaves(got)
    assert len(got_named) == len(want_leaves)
    for (name, g), w in zip(got_named, want_leaves):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        assert tuple(g.shape) == w.shape, name
        w = np.asarray(w, np.float64)
        tol = (2 * BF16_STEP if g.dtype == torch.bfloat16 else scaled) * np.abs(w).max()
        tol += param_atol if name.startswith("params.") else 0.0
        err = np.abs(to_numpy(g.double()) - w).max() if w.size else 0.0
        assert err <= tol + 1e-12, (name, err, np.abs(w).max())


@pytest.mark.parametrize("arch, variant", [("llama3-8b", v) for v in SETUPS]
                         + [("granite-moe-3b-a800m", "f32_moments")])
def test_one_step_from_a_carried_state_matches_the_reference(arch, variant):
    before, after, metrics, batch = _reference_run(arch, variant)
    _, tcfg = _cfgs(arch)
    state = train_state_from_numpy(before, "cpu")
    _assert_state(state, before, 0.0)           # carried exactly
    step = trainer.make_train_step(tcfg, _setup(trainer, **SETUPS[variant]))
    new, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(new.step) == int(after.step) == 3 and int(new.opt.step) == 3
    for key in ("loss", "grad_norm", "lr"):
        assert m[key].dtype == torch.float32
        assert float(m[key]) == pytest.approx(float(metrics[key]), rel=1e-5)
    # bfloat16 moments round m and v, so u differs by their rounding and a
    # parameter by lr times it
    lr = float(metrics["lr"])
    _assert_state(new, after, 1e-5,
                  param_atol=4 * BF16_STEP * lr if variant == "bf16_moments" else 0.0)
    # the step is functional: the state it was given is as it was
    _assert_state(state, before, 0.0)


def test_microbatch_accumulation_one_against_two():
    """One microbatch of 4 rows and two of 2 give the same mean loss and
    gradients, so the same step (float32 accumulation), as the reference's
    test_grad_accum_equivalence asks of it."""
    before, _, _, batch = _reference_run("llama3-8b", "f32_moments")
    _, tcfg = _cfgs("llama3-8b")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    outs = []
    for micro in (1, 2):
        step = trainer.make_train_step(tcfg, _setup(trainer, micro_batches=micro))
        outs.append(step(train_state_from_numpy(before, "cpu"), tb))
    (s1, m1), (s2, m2) = outs
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]), rel=1e-5)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()) + 1e-9)
    with pytest.raises(ValueError, match="microbatches"):
        trainer.make_train_step(tcfg, _setup(trainer, micro_batches=3))(s1, tb)


def _memorize(setup_kw: dict, steps: int, B: int, S: int) -> tuple[float, float, int]:
    """Train llama3-8b's smoke config (bfloat16, as the reference's tests)
    on one fixed batch: (first loss, last loss, the state's step)."""
    cfg = get_config("llama3-8b", smoke=True)
    setup = trainer.TrainSetup(**setup_kw)
    state = trainer.init_train_state(cfg, setup, torch.Generator().manual_seed(0), "cpu")
    step = trainer.cached_train_step(cfg, setup)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
             for k in ("tokens", "targets")}
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    return losses[0], losses[-1], int(state.step)


def test_train_loss_decreases():
    """The reference's test_train_loss_decreases: one fixed batch, the loss
    must drop markedly (memorization)."""
    first, last, step = _memorize(dict(micro_batches=2, learning_rate=1e-2,
                                       warmup_steps=2, total_steps=30, clip_norm=1.0),
                                  steps=25, B=4, S=32)
    assert last < first * 0.7, (first, last)
    assert step == 25


def test_compressed_training_still_learns():
    """The reference's test_compressed_training_still_learns."""
    first, last, _ = _memorize(dict(micro_batches=1, learning_rate=1e-2, warmup_steps=1,
                                    total_steps=30, compress_grads=True),
                               steps=20, B=2, S=16)
    assert last < first * 0.85, (first, last)


@pytest.mark.parametrize("variant", list(SETUPS))
@pytest.mark.parametrize("arch", ["llama3-8b", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_abstract_train_state_is_the_references_on_the_meta_device(arch, variant):
    """Names, shapes and dtypes of the full state (full-size configs), with
    no memory: every leaf on ``meta``; the same as an allocated state's at
    the smoke size."""
    cfg = get_config(arch)
    want = jtrainer.abstract_train_state(jax_get_config(arch),
                                         jtrainer.TrainSetup(**SETUPS[variant]))
    got = trainer.abstract_train_state(cfg, trainer.TrainSetup(**SETUPS[variant]))
    named = named_leaves(got)
    assert all(t.device.type == "meta" for _, t in named)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for _, t in named] == \
        [(tuple(w.shape), str(w.dtype)) for w in jax.tree.leaves(want)]
    small = get_config(arch, smoke=True)
    setup = trainer.TrainSetup(**SETUPS[variant])
    real = trainer.init_train_state(small, setup, torch.Generator().manual_seed(0), "cpu")
    meta = trainer.abstract_train_state(small, setup)
    assert [(n, t.shape, t.dtype) for n, t in named_leaves(real)] == \
        [(n, t.shape, t.dtype) for n, t in named_leaves(meta)]


def test_cached_train_step_is_one_function_per_config_and_setup():
    cfg = get_config("llama3-8b", smoke=True)
    a = trainer.cached_train_step(cfg, trainer.TrainSetup())
    assert trainer.cached_train_step(cfg, trainer.TrainSetup()) is a
    assert trainer.cached_train_step(cfg, trainer.TrainSetup(micro_batches=2)) is not a
