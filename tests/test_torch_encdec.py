"""The port's encoder-decoder family (seamless-m4t-medium: a bidirectional
encoder over precomputed frame embeddings, cross-attention in every
decoder layer) against the reference, on its smoke config with the
reference's weights carried across.

The encoder, ``prefill_encoder``'s cross-attention K/V, the decode step
and ``Engine.generate(frames=)`` agree with the reference's (float32
within 1e-5 / 1e-4, greedy tokens exact; bfloat16 within the serving
tolerance).  ``prefill_forward`` agrees where the memory is as long as
the prompt.  Where it is longer, the reference's prefill reads only the
first S_dec memory rows (its pure-JAX attention cuts k/v by q's length,
ROADMAP C10) while its decode path reads them all: the port's prefill
reads them all, equals the reference's decode path, and a test pins the
reference's prefill to the port's run on the truncated memory.  The
continuous batcher serves without a memory, as the reference's does
(``enc_len`` 0: every cross-attention adds nothing).  Frames come from
``torch_lm_cases.frontend_inputs``, as on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_continuous import _both, _serve
from test_torch_hybrid import bf16_drift
from test_torch_lm import BF16, DTYPES, F32_LOGITS, _model, _tokens, tols
from test_torch_parity import to_numpy, torch
from torch_lm_cases import BATCHER_SCENARIOS as SCENARIOS
from torch_lm_cases import frontend_inputs

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import ContinuousBatcher, Engine, Request

ARCH = "seamless-m4t-medium"
F32 = dict(atol=1e-5, rtol=1e-5)


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


def _frames(cfg, B, S_enc, seed=2):
    f = frontend_inputs(cfg, B, seed, enc_len=S_enc)["frames"]
    return jnp.asarray(f), torch.from_numpy(f)


def _close(got, want, tol):
    np.testing.assert_allclose(to_numpy(got.float()),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_references(smoke):
    want, got = jax_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert (got.encoder_layers, got.frontend) == (want.encoder_layers, "frames")


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_params_has_the_reference_tree_and_the_converter_carries_it(dtype):
    """The decoder's ``norm_cross``/``cross`` leaves, ``enc_layers`` and
    ``enc_final_norm``: the port's draws have the reference's shapes and
    dtypes, and the reference's weights arrive bit for bit."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(1)))
    mine = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    carried = lm_params_from_numpy(tree, "cpu")
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    names = set()
    for path, want in leaves:
        got, new = mine, carried
        for p in path:
            got, new = got[p.key], new[p.key]
        names.update(p.key for p in path)
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype)[6:] == str(new.dtype)[6:] == want.dtype.name, path
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(new.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(new.numpy(), want)
    assert {"cross", "norm_cross", "enc_layers", "enc_final_norm"} <= names
    assert mine["enc_layers"]["mixer"]["wq"]["w"].shape[0] == tcfg.encoder_layers


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_prefill_encoder_match_the_reference(dtype):
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, dtype)
    fj, ft = _frames(jcfg, 2, 24)
    _close(lm.encode(tcfg, tparams, ft), jlm.encode(jcfg, jparams, fj), _tol(dtype))
    jc = jlm.prefill_encoder(jcfg, jparams, jlm.init_cache(jcfg, 2, 8), fj)
    tc = lm.prefill_encoder(tcfg, tparams, lm.init_cache(tcfg, 2, 8, device="cpu"), ft)
    for pos in range(jcfg.block_period):
        for name in ("ck", "cv"):
            want = jc[f"pos{pos}"][name]
            assert tuple(tc[f"pos{pos}"][name].shape) == want.shape == (
                jcfg.num_blocks, 2, 24, jcfg.num_kv_heads, jcfg.head_dim)
            _close(tc[f"pos{pos}"][name], want, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_forward_matches_the_reference_where_memory_and_prompt_are_one_length(dtype):
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, dtype)
    toks = _tokens(jcfg, 2, 16, seed=4)
    fj, ft = _frames(jcfg, 2, 16)
    jlog, jkv = jax.jit(jlm.prefill_forward(jcfg))(
        jparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks), "frames": fj})
    tlog, tkv = lm.prefill_forward(tcfg)(tparams, {"tokens": torch.from_numpy(toks),
                                                   "frames": ft})
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **tols(dtype))
    assert set(tkv) == set(jkv)
    for name in ("k", "v"):
        _close(tkv["pos0"][name], jkv["pos0"][name], _tol(dtype))


def _decode_route(jcfg, jparams, toks, fj):
    """The reference's decode path: the encoder into the cache, then the
    prompt token by token; its last-position logits."""
    jeng = JaxEngine(jcfg, jparams, max_seq=toks.shape[1], batch_size=toks.shape[0],
                     enc_len=fj.shape[1])
    cache = jlm.prefill_encoder(jcfg, jparams, jeng.new_cache(), fj)
    return np.asarray(jeng.prefill(cache, jnp.asarray(toks))[1])


@pytest.mark.parametrize("S_enc,S_dec", [(64, 16), (48, 8), (40, 12)])
def test_prefill_forward_reads_every_memory_row_as_the_references_decode_path(S_enc,
                                                                              S_dec):
    """A memory longer than the prompt: the port's prefill (the flash
    kernel's plain version at Skv = S_enc) equals the reference's decode
    path, and so does the port's own."""
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, "float32")
    toks = _tokens(jcfg, 2, S_dec, seed=5)
    fj, ft = _frames(jcfg, 2, S_enc)
    tlog, _ = lm.prefill_forward(tcfg)(tparams, {"tokens": torch.from_numpy(toks),
                                                 "frames": ft})
    want = _decode_route(jcfg, jparams, toks, fj)
    np.testing.assert_allclose(to_numpy(tlog), want, **F32_LOGITS)
    teng = Engine(tcfg, tparams, max_seq=S_dec, batch_size=2, device="cpu", enc_len=S_enc)
    cache = lm.prefill_encoder(tcfg, tparams, teng.new_cache(), ft)
    _, step = teng.prefill(cache, torch.from_numpy(toks))
    np.testing.assert_allclose(to_numpy(step), want, **F32_LOGITS)


def test_the_references_prefill_reads_only_the_first_s_dec_memory_rows(monkeypatch):
    """ROADMAP C10, pinned: the reference's prefill_forward with a 64-row
    memory and a 16-token prompt is the port's prefill on the memory cut
    to its first 16 rows (encoded over all 64 frames), and differs from
    the full answer."""
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, "float32")
    toks = _tokens(jcfg, 2, 16, seed=5)
    fj, ft = _frames(jcfg, 2, 64)
    jlog, _ = jax.jit(jlm.prefill_forward(jcfg))(
        jparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks), "frames": fj})
    full, _ = lm.prefill_forward(tcfg)(tparams, {"tokens": torch.from_numpy(toks),
                                                 "frames": ft})
    encode = lm.encode
    monkeypatch.setattr(lm, "encode", lambda cfg, p, f: encode(cfg, p, f)[:, :16])
    cut, _ = lm.prefill_forward(tcfg)(tparams, {"tokens": torch.from_numpy(toks),
                                                "frames": ft})
    np.testing.assert_allclose(to_numpy(cut), np.asarray(jlog), **F32_LOGITS)
    assert float(np.abs(to_numpy(full) - np.asarray(jlog)).max()) > 1e-2
    # and a prompt longer than the memory the reference refuses
    with pytest.raises(TypeError):
        jlm.prefill_forward(jcfg)(jparams, {"tokens": jnp.asarray(toks),
                                            "targets": jnp.asarray(toks),
                                            "frames": fj[:, :8]})
    monkeypatch.undo()
    longer, _ = lm.prefill_forward(tcfg)(tparams, {"tokens": torch.from_numpy(toks),
                                                   "frames": ft[:, :8]})
    np.testing.assert_allclose(to_numpy(longer), _decode_route(jcfg, jparams, toks,
                                                               fj[:, :8]), **F32_LOGITS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_step_matches_the_reference_after_the_encoder(dtype):
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, dtype)
    B, T = 2, 8
    toks = _tokens(jcfg, B, T, seed=7)
    fj, ft = _frames(jcfg, B, 20)
    jc = jlm.prefill_encoder(jcfg, jparams, jlm.init_cache(jcfg, B, 12, enc_len=20), fj)
    tc = lm.prefill_encoder(tcfg, tparams, lm.init_cache(tcfg, B, 12, device="cpu",
                                                         enc_len=20), ft)
    jstep, tstep = jax.jit(jlm.serve_step(jcfg)), lm.serve_step(tcfg)
    for t in range(T):
        jlog, jc = jstep(jparams, jc, jnp.asarray(toks[:, t:t + 1]))
        tlog, tc = tstep(tparams, tc, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **tols(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_generate_with_frames_matches_the_reference(dtype):
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, dtype)
    B, T, new, S_enc = 2, 6, 8, 40
    prompts = _tokens(jcfg, B, T, seed=6)
    fj, ft = _frames(jcfg, B, S_enc)
    teng = Engine(tcfg, tparams, max_seq=32, batch_size=B, device="cpu", enc_len=S_enc)
    got = teng.generate(None, torch.from_numpy(prompts), new, frames=ft)
    assert got.dtype == torch.int32 and got.shape == (B, new)
    assert bool(((got >= 0) & (got < jcfg.vocab_size)).all())
    if dtype == "float32":
        jeng = JaxEngine(jcfg, jparams, max_seq=32, batch_size=B, enc_len=S_enc)
        want = jeng.generate(jax.random.PRNGKey(0), jnp.asarray(prompts), new, frames=fj)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the memory moves the tokens: without frames the cache holds zeros
        bare = teng.generate(None, torch.from_numpy(prompts), new)
        assert not torch.equal(bare, got)


def test_bf16_drift_is_no_larger_than_the_references():
    """A memory as long as the prompt, where the reference's prefill is
    right."""
    d = bf16_drift(ARCH, 16, 12, extra=lambda cfg, B: frontend_inputs(cfg, B, 5,
                                                                       enc_len=12))
    for route in ("full", "step"):
        assert d[route]["f32"] <= 1e-4
        assert d[route]["port"] <= 1.5 * d[route]["ref"], d


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_batcher_without_a_memory_matches_the_reference(scenario):
    """``enc_len`` 0, as the reference's batcher builds its cache: outputs
    and finish order exact in float32."""
    model = _model(ARCH, "float32")
    want, got = _both(model, scenario)
    assert got == want
    cb = ContinuousBatcher(model[3], model[5], max_seq=8, n_slots=1, device="cpu")
    assert all(tuple(cb.cache[f"pos{p}"]["ck"].shape)[2] == 0
               for p in range(model[3].block_period))


def test_memoryless_cross_attention_adds_nothing():
    """The batcher's seamless equals the same decoder with its cross
    leaves taken out (ROADMAP C9): with no memory rows, every
    cross-attention adds zero."""
    _, _, _, tcfg, _, tparams = _model(ARCH, "float32")
    dec = dataclasses.replace(tcfg, encoder_layers=0, family="dense", frontend=None)
    dec_params = {k: v for k, v in tparams.items() if not k.startswith("enc_")}
    dec_params["layers"] = {pos: {k: v for k, v in p.items()
                                  if k not in ("cross", "norm_cross")}
                            for pos, p in tparams["layers"].items()}
    for scenario in ("five_on_two", "recycled_slot"):
        _, with_cross = _serve(ContinuousBatcher, Request, tcfg, tparams, scenario, None,
                               device="cpu")
        _, without = _serve(ContinuousBatcher, Request, dec, dec_params, scenario, None,
                            device="cpu")
        assert with_cross == without
