"""The port's LM serving path against the reference, on the seven ported
smoke configs (the dense GQA transformers llama3-8b, command-r-plus-104b
with its parallel block and tied embeddings, qwen1.5-110b with its qkv
bias, yi-34b with 7 heads of head_dim 8; rwkv6-7b: Finch; the MoE
granite-moe-3b-a800m and qwen2-moe-a2.7b with shared experts), with the
reference's weights carried across by ``lm_params_from_numpy``.

In float32 (``dataclasses.replace(SMOKE, dtype="float32")``) the
algorithm is held tight: logits within 1e-4, greedy tokens identical.  In
bfloat16 XLA and torch round at different points, so the reference's own
serving tolerance holds (tests/test_serve.py: atol 0.08, rtol 0.05).
``rwkv6_init`` sets the bonus ``u`` to zeros; the tests overwrite it with
seeded values on both sides so the bonus term is exercised."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import to_numpy, torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models import nn as jnn
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import SamplingParams as JaxSamplingParams
from repro.serve.engine import sample_token as jax_sample_token
from repro_torch.configs import get_config
from repro_torch.models import lm, nn, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import Engine, SamplingParams, sample_token

ARCHS = ["llama3-8b", "rwkv6-7b", "command-r-plus-104b", "qwen1.5-110b", "yi-34b",
         "granite-moe-3b-a800m", "qwen2-moe-a2.7b"]
DTYPES = ["float32", "bfloat16"]
F32_LOGITS = dict(atol=1e-4, rtol=0.0)
BF16 = dict(atol=0.08, rtol=0.05)          # tests/test_serve.py


def tols(dtype):
    return F32_LOGITS if dtype == "float32" else BF16


@functools.lru_cache(maxsize=None)
def _model(arch, dtype):
    """(arch, dtype, jax cfg, port cfg, jax params, port params)."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    if jcfg.family == "ssm":
        u = tree["layers"]["pos0"]["mixer"]["u"]
        tree["layers"]["pos0"]["mixer"]["u"] = (
            np.random.default_rng(7).normal(size=u.shape) * 0.5).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return arch, dtype, jcfg, tcfg, jparams, lm_params_from_numpy(tree, "cpu")


@pytest.fixture(params=[(a, d) for a in ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    return _model(*request.param)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, T)).astype(np.int32)


# -- configs and parameters ---------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_are_the_references(arch, smoke):
    assert ([f.name for f in dataclasses.fields(ModelConfig)]
            == [f.name for f in dataclasses.fields(JaxModelConfig)])
    want = jax_get_config(arch, smoke=smoke)
    got = get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.block_program() == want.block_program()
    assert (got.num_blocks, got.head_dim, got.rwkv_heads) == (
        want.num_blocks, want.head_dim, want.rwkv_heads)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_every_reference_id_is_ported_or_raises_naming_the_roadmap(arch):
    """All ten ids are ported now (the last three, the hybrid, vlm and
    encdec families, in tests/test_torch_hybrid.py, test_torch_vlm.py and
    test_torch_encdec.py): each resolves, and its smoke config builds a
    cache and a decode step."""
    cfg = get_config(arch)
    assert cfg.name == arch
    smoke = get_config(arch, smoke=True)
    cache = lm.init_cache(smoke, batch=1, max_seq=4, device="cpu")
    assert cache["len"] == 0 and len(cache) == smoke.block_period + 1
    lm.serve_step(smoke)


def test_unported_families_raise_naming_the_roadmap():
    """The setups that raised for ROADMAP A9 build now: a hybrid (Mamba
    between attention layers) and an encoder on a dense config."""
    hybrid = dataclasses.replace(get_config("granite-moe-3b-a800m", smoke=True),
                                 family="hybrid", attn_every=2, dtype="float32")
    params = lm.init_params(hybrid, torch.Generator().manual_seed(0), "cpu")
    assert set(params["layers"]["pos1"]["mixer"]) >= {"A_log", "conv_w", "in_proj"}
    toks = torch.ones(1, 3, dtype=torch.int32)
    logits, _ = lm.prefill_forward(hybrid)(params, {"tokens": toks})
    assert bool(torch.isfinite(logits).all())
    encdec = dataclasses.replace(get_config("llama3-8b", smoke=True),
                                 family="encdec", encoder_layers=2, dtype="float32")
    cache = lm.init_cache(encdec, batch=1, max_seq=4, device="cpu", enc_len=3)
    assert tuple(cache["pos0"]["ck"].shape) == (2, 1, 3, 2, 16)
    params = lm.init_params(encdec, torch.Generator().manual_seed(0), "cpu")
    logits, _ = lm.prefill_forward(encdec)(params, {"tokens": toks,
                                                     "frames": torch.zeros(1, 5, 64)})
    assert bool(torch.isfinite(logits).all())
    # the MoE family is ported too
    moe = dataclasses.replace(get_config("llama3-8b", smoke=True), family="moe",
                              num_experts=4, experts_per_token=2)
    params = lm.init_params(moe, torch.Generator().manual_seed(0), "cpu")
    assert params["layers"]["pos0"]["ffn"]["gate"].shape == (2, 4, 64, 128)
    lm.serve_step(moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree_shapes_and_dtypes(arch):
    cfg = get_config(arch, smoke=True)
    want = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: jlm.init_params(jax_get_config(arch, smoke=True),
                                               jax.random.PRNGKey(0))))[0]
    got = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat[path] = t
    walk(got, ())
    assert len(flat) == len(want)
    for path, leaf in want:
        key = tuple(p.key for p in path)
        assert tuple(flat[key].shape) == leaf.shape, key
        assert str(flat[key].dtype).replace("torch.", "") == leaf.dtype.name, key
    # the reference's scales: embeddings 0.02, a linear 1/sqrt(d_in) (the
    # head, or with tied embeddings the first layer's wq)
    assert abs(float(got["embed"]["table"].float().std()) - 0.02) < 2e-3
    w = (got["lm_head"]["w"] if "lm_head" in got
         else got["layers"]["pos0"]["mixer"]["wq"]["w"]).float()
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05


@pytest.mark.parametrize("dtype", DTYPES)
def test_converter_carries_every_leaf_bit_for_bit(dtype):
    cfg = dataclasses.replace(jax_get_config("rwkv6-7b", smoke=True), dtype=dtype)
    tree = jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(3)))
    got = lm_params_from_numpy(tree, "cpu")
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, want in leaves:
        t = got
        for p in path:
            t = t[p.key]
        assert str(t.dtype).replace("torch.", "") == want.dtype.name
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)


# -- primitives -------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_nn_primitives_match_the_reference(dtype):
    rng = np.random.default_rng(0)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = jnp.asarray(rng.normal(size=(2, 7, 4, 16)).astype(np.float32), jdt)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
    scale = jnp.asarray(rng.normal(size=(16,)).astype(np.float32), jdt)
    st = torch.from_numpy(np.array(scale.astype(jnp.float32))).to(tdt)
    bias = scale * 0.5
    bt = st * 0.5
    tol = dict(atol=2e-6, rtol=2e-6) if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)

    def close(got, want):
        np.testing.assert_allclose(to_numpy(got.float()),
                                   np.asarray(want.astype(jnp.float32)), **tol)
    close(nn.rmsnorm({"scale": st}, xt), jnn.rmsnorm({"scale": scale}, x))
    close(nn.layernorm({"scale": st, "bias": bt}, xt),
          jnn.layernorm({"scale": scale, "bias": bias}, x))
    pos = np.arange(7)[None, :] + np.array([[0], [30]])
    close(nn.apply_rope(xt, torch.from_numpy(pos), 5e5),
          jnn.apply_rope(x, jnp.asarray(pos), 5e5))
    ws = {n: jnp.asarray(rng.normal(size=s).astype(np.float32) * 0.3, jdt)
          for n, s in (("gate", (16, 24)), ("up", (16, 24)), ("down", (24, 16)))}
    jp = {n: {"w": w} for n, w in ws.items()}
    tp = {n: {"w": torch.from_numpy(np.array(w.astype(jnp.float32))).to(tdt)}
          for n, w in ws.items()}
    close(nn.swiglu(tp, xt[:, :, 0]), jnn.swiglu(jp, x[:, :, 0]))


# -- RWKV6 mixers -------------------------------------------------------------------
def _rwkv_block(model, b=1):
    _, dtype, jcfg, tcfg, jparams, tparams = model
    jp = jax.tree.map(lambda a: a[b], jparams["layers"]["pos0"]["mixer"])
    tp = {k: (v[b] if not isinstance(v, dict) else {kk: vv[b] for kk, vv in v.items()})
          for k, v in tparams["layers"]["pos0"]["mixer"].items()}
    return jp, tp


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv6_mixers_match_the_reference_full_sequence_and_step(dtype):
    model = _model("rwkv6-7b", dtype)
    jcfg = model[2]
    jp, tp = _rwkv_block(model)
    hs, d = jcfg.rwkv_head_size, jcfg.d_model
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(np.random.default_rng(1).normal(size=(2, 9, d)).astype(np.float32), jdt)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.float32 if dtype == "float32" else torch.bfloat16)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else BF16

    def close(got, want):
        np.testing.assert_allclose(to_numpy(got.float()),
                                   np.asarray(want.astype(jnp.float32)), **tol)
    close(ssm.rwkv6_time_mix(tp, xt, head_size=hs),
          jssm.rwkv6_time_mix(jp, x, head_size=hs))
    close(ssm.rwkv6_channel_mix(tp, xt), jssm.rwkv6_channel_mix(jp, x))
    # steps from a non-zero carried state, token by token
    S0 = np.random.default_rng(2).normal(size=(2, d // hs, hs, hs)).astype(np.float32)
    jc = dict(jssm.rwkv6_init_cache(2, d, hs, dtype=jdt), S=jnp.asarray(S0))
    tc = dict(ssm.rwkv6_init_cache(2, d, hs, dtype=xt.dtype, device="cpu"),
              S=torch.from_numpy(S0))
    for name in ("x_tm", "x_cm"):
        assert tc[name].dtype == xt.dtype and tuple(tc[name].shape) == jc[name].shape
    for t in range(3):
        jy, jc = jssm.rwkv6_time_mix_step(jp, x[:, t:t + 1], jc, head_size=hs)
        ty, tc = ssm.rwkv6_time_mix_step(tp, xt[:, t:t + 1], tc, head_size=hs)
        close(ty, jy)
        close(tc["S"], jc["S"])
        jy, jc = jssm.rwkv6_channel_mix_step(jp, x[:, t:t + 1], jc)
        ty, tc = ssm.rwkv6_channel_mix_step(tp, xt[:, t:t + 1], tc)
        close(ty, jy)
        close(tc["x_cm"], jc["x_cm"])


# -- the serving path -----------------------------------------------------------------
def test_prefill_forward_matches_the_reference(model):
    arch, dtype, jcfg, tcfg, jparams, tparams = model
    toks = _tokens(jcfg, 2, 16, seed=4)
    jlog, jkv = jax.jit(jlm.prefill_forward(jcfg))(
        jparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks)})
    tlog, tkv = lm.prefill_forward(tcfg)(tparams, {"tokens": torch.from_numpy(toks)})
    assert tlog.dtype == torch.float32 and tlog.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **tols(dtype))
    assert set(tkv) == set(jkv)
    for pos in jkv:
        for name in ("k", "v"):
            np.testing.assert_allclose(
                to_numpy(tkv[pos][name].float()),
                np.asarray(jkv[pos][name].astype(jnp.float32)),
                **(dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else BF16))


def test_serve_step_matches_the_reference_over_ten_tokens(model):
    arch, dtype, jcfg, tcfg, jparams, tparams = model
    B, T, max_seq = 2, 10, 16
    toks = _tokens(jcfg, B, T, seed=5)
    jstep = jax.jit(jlm.serve_step(jcfg))
    tstep = lm.serve_step(tcfg)
    jc = jlm.init_cache(jcfg, batch=B, max_seq=max_seq)
    tc = lm.init_cache(tcfg, batch=B, max_seq=max_seq, device="cpu")
    for t in range(T):
        jlog, jc = jstep(jparams, jc, jnp.asarray(toks[:, t:t + 1]))
        tlog, tc = tstep(tparams, tc, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **tols(dtype))
    assert tc["len"] == int(jc["len"]) == T
    state = "S" if jcfg.family == "ssm" else "k"
    np.testing.assert_allclose(
        to_numpy(tc["pos0"][state].float()),
        np.asarray(jc["pos0"][state].astype(jnp.float32)),
        **(dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else BF16))


def test_engine_generate_matches_the_reference(model):
    arch, dtype, jcfg, tcfg, jparams, tparams = model
    B, T, new = 2, 6, 8
    prompts = _tokens(jcfg, B, T, seed=6)
    jeng = JaxEngine(jcfg, jparams, max_seq=32, batch_size=B)
    teng = Engine(tcfg, tparams, max_seq=32, batch_size=B, device="cpu")
    _, jlog = jeng.prefill(jeng.new_cache(), jnp.asarray(prompts))
    _, tlog = teng.prefill(teng.new_cache(), torch.from_numpy(prompts))
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **tols(dtype))
    got = teng.generate(None, torch.from_numpy(prompts), new)
    assert got.dtype == torch.int32 and got.shape == (B, new)
    assert bool(((got >= 0) & (got < jcfg.vocab_size)).all())
    if dtype == "float32":
        want = jeng.generate(jax.random.PRNGKey(0), jnp.asarray(prompts), new)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_prefill_equals_prefill_forward_on_the_port(model):
    """The two prefills of the port (token by token through the decode
    step, and the full-sequence prefill_forward) give one set of logits.
    An MoE's capacity grows with the sequence (one token a step never
    overflows; 12 at once may), so there the capacity factor is raised
    until no token is dropped, and the two paths compute the same sum."""
    arch, dtype, jcfg, tcfg, jparams, tparams = model
    if tcfg.num_experts:
        tcfg = dataclasses.replace(
            tcfg, capacity_factor=tcfg.num_experts / tcfg.experts_per_token)
    prompts = torch.from_numpy(_tokens(jcfg, 2, 12, seed=8))
    teng = Engine(tcfg, tparams, max_seq=16, batch_size=2, device="cpu")
    _, step_logits = teng.prefill(teng.new_cache(), prompts)
    full, _ = lm.prefill_forward(tcfg)(tparams, {"tokens": prompts})
    np.testing.assert_allclose(to_numpy(step_logits), to_numpy(full), **tols(dtype))


def test_serve_step_refuses_a_position_past_the_cache():
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = lm.init_cache(cfg, batch=1, max_seq=2, device="cpu")
    step = lm.serve_step(cfg)
    tok = torch.ones(1, 1, dtype=torch.int32)
    for _ in range(2):
        _, cache = step(params, cache, tok)
    with pytest.raises(ValueError, match="does not fit"):
        step(params, cache, tok)


def test_entry_points_default_to_cuda_and_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, batch=1, max_seq=4)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params, max_seq=4, batch_size=1)


# -- sampling ----------------------------------------------------------------------------
def test_greedy_sampling_matches_the_reference_and_takes_the_first_maximum():
    logits = np.asarray([[0.0, 5.0, 1.0, 5.0], [2.0, -1.0, 2.0, 0.5]], np.float32)
    want = jax_sample_token(jax.random.PRNGKey(0), jnp.asarray(logits),
                            JaxSamplingParams())
    got = sample_token(torch.from_numpy(logits), SamplingParams())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [1, 0])


def test_temperature_sampling_stays_in_the_top_k_support():
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.normal(size=(64, 50)).astype(np.float32))
    top3 = torch.topk(logits, 3, dim=-1).indices
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(20):
        s = sample_token(logits, SamplingParams(temperature=1.0, top_k=3), gen)
        assert bool((top3 == s[:, None].long()).any(-1).all())
        seen.update(s.tolist())
    assert len(seen) > 3                 # it draws, not only argmaxes
    a = sample_token(logits, SamplingParams(temperature=0.7, top_k=5),
                     torch.Generator().manual_seed(1))
    b = sample_token(logits, SamplingParams(temperature=0.7, top_k=5),
                     torch.Generator().manual_seed(1))
    assert torch.equal(a, b)             # the explicit generator decides
