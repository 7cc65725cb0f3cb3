"""The port's training loss (``repro_torch.models.lm.train_loss``) against
the reference's, for all ten smoke ids in float32: the port's seeded
weights (``torch_lm_cases.smoke_lm``) carried into the reference as numpy
arrays, one batch from a fixed numpy seed (a vlm's patch embeddings and
an encdec's frames among it, the memory as long as the prompt, ROADMAP
C10), and the loss, its two parts and every gradient leaf compared; the
chunked cross-entropy, and the C10 and C11 pins.  Mamba's backward and the
kernels' Functions are in ``test_torch_train_grads.py``.

Loss, ``ce`` and ``aux`` are held at 1e-5 relative; each gradient leaf
within 1e-4 of its largest magnitude in the reference.  The reference
trains through its pure-JAX chunked flash attention and chunked WKV scan;
the port through the kernels' ``autograd.Function``s, whose backward is a
plain float32 recompute, so the gradients agree to float32 rounding."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import to_numpy, torch
from torch_lm_cases import smoke_lm, train_batch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.models import lm
from repro_torch.train.optimizer import tree_leaves, tree_map

LOSS_RTOL = 1e-5
GRAD_SCALED = 1e-4


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """(jax cfg, port cfg, jax params, port params): the port's seeded
    float32 smoke weights, carried into the reference."""
    tcfg, tparams = smoke_lm(arch, seed=0)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
    jparams = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy().copy(), tparams))
    return jcfg, tcfg, jparams, tparams


def _port_grads(cfg, params, batch):
    """(loss, metrics, gradient leaves in ``tree_leaves`` order)."""
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss, metrics = lm.train_loss(cfg)(leaves, batch)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss, metrics, [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, flat)]


def _assert_grads(got: list, want, what: str = ""):
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        err = np.abs(to_numpy(g).astype(np.float64) - w).max()
        assert err <= GRAD_SCALED * np.abs(w).max() + 1e-12, (what, err, np.abs(w).max())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_gradients_match_the_reference(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    batch = train_batch(tcfg, 2, 16, seed=3)
    (jloss, jm), jgrads = jax.value_and_grad(jlm.train_loss(jcfg), has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_grads(tcfg, tparams,
                                       {k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.dtype == torch.float32 and loss.grad_fn is not None
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    ce, aux = (float(metrics[k].detach()) for k in ("ce", "aux"))
    assert ce == pytest.approx(float(jm["ce"]), rel=LOSS_RTOL)
    assert aux == pytest.approx(float(jm["aux"]), rel=LOSS_RTOL, abs=1e-12)
    if tcfg.num_experts:
        assert aux > 0
    _assert_grads(grads, jgrads, arch)


def test_train_loss_without_grad_equals_the_loss_with_it():
    """``train_loss`` under ``no_grad`` (no checkpointing, the in-place
    Mamba route) gives the loss the grad route gives, on jamba."""
    _, tcfg, _, tparams = _model("jamba-1.5-large-398b")
    batch = {k: torch.from_numpy(v) for k, v in train_batch(tcfg, 2, 16, seed=4).items()}
    with torch.no_grad():
        plain, _ = lm.train_loss(tcfg)(tparams, batch)
    graded, _, _ = _port_grads(tcfg, tparams, batch)
    assert float(plain) == pytest.approx(float(graded.detach()), rel=1e-6)


@pytest.mark.parametrize("S, chunk", [(32, 512), (64, 16), (48, 16)])
def test_chunked_cross_entropy_matches_the_reference(S, chunk):
    """Lengths whose chunks divide evenly: the mean CE and its gradients
    in x and the head, a masked tail among the targets."""
    rng = np.random.default_rng(S + chunk)
    B, d, V = 2, 8, 40
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    table_T = rng.normal(size=(d, V)).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    jf = lambda x_, t_: jlm.chunked_cross_entropy(x_, t_, jnp.asarray(targets),  # noqa: E731
                                                  jnp.asarray(mask), chunk=chunk)
    jce, (jgx, jgt) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                                            jnp.asarray(table_T))
    tx, tt = (torch.from_numpy(a).requires_grad_() for a in (x, table_T))
    ce = lm.chunked_cross_entropy(tx, tt, torch.from_numpy(targets),
                                  torch.from_numpy(mask), chunk=chunk)
    gx, gt = torch.autograd.grad(ce, (tx, tt))
    assert float(ce) == pytest.approx(float(jce), rel=LOSS_RTOL)
    _assert_grads([gx, gt], [jgx, jgt])


def test_the_references_chunked_ce_drops_a_tail_and_the_ports_counts_every_token():
    """ROADMAP C11, pinned: at S = 17 with chunks of 8 the reference sizes
    its chunks S // (S // 8) = 8 and covers 16 positions, so its loss is
    the port's over the first 16; the port's over all 17 is the plain
    mean over every token."""
    rng = np.random.default_rng(11)
    B, S, d, V = 2, 17, 8, 30
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    table_T = rng.normal(size=(d, V)).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    ref = float(jlm.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(table_T),
                                          jnp.asarray(targets), jnp.asarray(mask), chunk=8))
    t = [torch.from_numpy(a) for a in (x, table_T, targets, mask)]
    cut = float(lm.chunked_cross_entropy(t[0][:, :16], t[1], t[2][:, :16], t[3][:, :16],
                                         chunk=8))
    full = float(lm.chunked_cross_entropy(*t, chunk=8))
    logits = t[0] @ t[1]
    plain = torch.nn.functional.cross_entropy(logits.reshape(-1, V), t[2].reshape(-1).long())
    assert ref == pytest.approx(cut, rel=LOSS_RTOL)
    assert full == pytest.approx(float(plain), rel=LOSS_RTOL)
    assert abs(full - ref) > 1e-4


def test_training_cross_attention_reads_every_memory_row_the_references_the_first_s(
        monkeypatch):
    """ROADMAP C10 in training, pinned: with 32 frames and 16 tokens the
    reference's loss is the port's with the memory cut to its first 16
    rows (encoded over all 32 frames), and differs from the port's over
    the whole memory; with 8 frames the reference raises and the port
    trains."""
    jcfg, tcfg, jparams, tparams = _model("seamless-m4t-medium")
    batch = train_batch(tcfg, 2, 16, seed=5)
    frames = (np.random.default_rng(6).normal(size=(2, 32, tcfg.d_model)) * 0.02
              ).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in dict(batch, frames=frames).items()}
    tb = {k: torch.from_numpy(v) for k, v in dict(batch, frames=frames).items()}
    jloss, _ = jlm.train_loss(jcfg)(jparams, jb)
    full, _ = lm.train_loss(tcfg)(tparams, tb)
    encode = lm.encode
    monkeypatch.setattr(lm, "encode", lambda cfg, p, f: encode(cfg, p, f)[:, :16])
    cut, _ = lm.train_loss(tcfg)(tparams, tb)
    assert float(cut) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert abs(float(full) - float(jloss)) > 1e-4
    monkeypatch.undo()
    with pytest.raises(TypeError):
        jlm.train_loss(jcfg)(jparams, dict(jb, frames=jb["frames"][:, :8]))
    short, _ = lm.train_loss(tcfg)(tparams, dict(tb, frames=tb["frames"][:, :8]))
    assert torch.isfinite(short)
