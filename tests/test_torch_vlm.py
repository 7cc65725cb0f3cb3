"""The port's vlm family (phi-3-vision-4.2b: a dense GQA backbone behind a
patch-embedding frontend stub) against the reference, on its smoke config
with the reference's weights carried across.

``prefill_forward`` puts ``batch["frontend_embeds"]`` ``[B, P, d]`` in
front of the token embeddings and numbers positions over P + S; without
them it is a text model.  Serving is text-only in both packages.  Float32
within 1e-4 (logits) and 1e-5 (K/V taps), greedy tokens exact; bfloat16
within the reference's serving tolerance.  The seeded embeddings come
from ``torch_lm_cases.frontend_inputs``, as on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_continuous import _both
from test_torch_hybrid import bf16_drift
from test_torch_lm import BF16, DTYPES, _model, _tokens, tols
from test_torch_parity import to_numpy, torch
from torch_lm_cases import BATCHER_SCENARIOS as SCENARIOS
from torch_lm_cases import frontend_inputs

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve import Engine

ARCH = "phi-3-vision-4.2b"


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_references(smoke):
    want, got = jax_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert (got.frontend, got.frontend_positions, got.head_dim) == (
        "patches", 576 if not smoke else 16, 96 if not smoke else 16)


def _batches(jcfg, B, T, with_frontend, seed=4):
    toks = _tokens(jcfg, B, T, seed=seed)
    more = frontend_inputs(jcfg, B, seed) if with_frontend else {}
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks),
          **{k: jnp.asarray(v) for k, v in more.items()}}
    tb = {"tokens": torch.from_numpy(toks), **{k: torch.from_numpy(v) for k, v in more.items()}}
    return jb, tb


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_frontend", [True, False])
def test_prefill_forward_matches_the_reference(dtype, with_frontend):
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, dtype)
    B, T = 2, 12
    jb, tb = _batches(jcfg, B, T, with_frontend)
    jlog, jkv = jax.jit(jlm.prefill_forward(jcfg))(jparams, jb)
    tlog, tkv = lm.prefill_forward(tcfg)(tparams, tb)
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **tols(dtype))
    S = T + (jcfg.frontend_positions if with_frontend else 0)
    assert set(tkv) == set(jkv)
    for pos in jkv:
        for name in ("k", "v"):
            assert tuple(tkv[pos][name].shape) == jkv[pos][name].shape == (
                jcfg.num_blocks, B, S, jcfg.num_kv_heads, jcfg.head_dim)
            np.testing.assert_allclose(
                to_numpy(tkv[pos][name].float()),
                np.asarray(jkv[pos][name].astype(jnp.float32)),
                **(dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else BF16))


def test_frontend_embeddings_lead_the_sequence():
    """With the patches in front, the text's K/V taps are those of the
    text at positions P.., and the logits move; the patch rows alone
    decide the first P taps."""
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, "float32")
    jb, tb = _batches(jcfg, 2, 12, True)
    P = jcfg.frontend_positions
    with_fe, kv = lm.prefill_forward(tcfg)(tparams, tb)
    text, kv_text = lm.prefill_forward(tcfg)(tparams, {"tokens": tb["tokens"]})
    assert float((with_fe - text).abs().max()) > 1e-3
    # layer 0's values do not depend on position: the text rows' are equal
    np.testing.assert_allclose(to_numpy(kv["pos0"]["v"][0, :, P:]),
                               to_numpy(kv_text["pos0"]["v"][0]), atol=1e-6, rtol=1e-6)
    patches_only, kv_p = lm.prefill_forward(tcfg)(
        tparams, {"tokens": tb["tokens"][:, :1],
                  "frontend_embeds": tb["frontend_embeds"]})
    np.testing.assert_allclose(to_numpy(kv["pos0"]["k"][:, :, :P]),
                               to_numpy(kv_p["pos0"]["k"][:, :, :P]), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_generate_is_text_only_and_matches_the_reference(dtype):
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, dtype)
    B, T, new = 2, 6, 8
    prompts = _tokens(jcfg, B, T, seed=6)
    jeng = JaxEngine(jcfg, jparams, max_seq=32, batch_size=B)
    teng = Engine(tcfg, tparams, max_seq=32, batch_size=B, device="cpu")
    _, jlog = jeng.prefill(jeng.new_cache(), jnp.asarray(prompts))
    _, tlog = teng.prefill(teng.new_cache(), torch.from_numpy(prompts))
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **tols(dtype))
    got = teng.generate(None, torch.from_numpy(prompts), new)
    assert got.shape == (B, new)
    if dtype == "float32":
        want = jeng.generate(jax.random.PRNGKey(0), jnp.asarray(prompts), new)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the text-only prefill_forward is the Engine's prefill
        full, _ = lm.prefill_forward(tcfg)(tparams, {"tokens": torch.from_numpy(prompts)})
        np.testing.assert_allclose(to_numpy(tlog), to_numpy(full), **tols(dtype))


def test_bf16_drift_with_frontend_is_no_larger_than_the_references():
    d = bf16_drift(ARCH, 16, 12, extra=lambda cfg, B: frontend_inputs(cfg, B, 5))
    for route in ("full", "step"):
        assert d[route]["f32"] <= 1e-4
        assert d[route]["port"] <= 1.5 * d[route]["ref"], d


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_batcher_matches_the_reference_in_float32(scenario):
    want, got = _both(_model(ARCH, "float32"), scenario)
    assert got == want
