"""The port's hybrid family (jamba-1.5-large-398b: one attention layer in
every period-8 block, Mamba at the other seven, MoE at the odd positions)
against the reference, on its smoke config with the reference's weights
carried across.

In float32 the logits agree within 1e-4, the K/V taps and the Mamba
states within 1e-5 (1e-4 after ten steps), and greedy tokens exactly.  In
bfloat16 the last-token logits of the smoke config drift from the float32
answer of the same weights by ~0.2 relative in the reference itself (its
MoE's near-uniform random routers send some tokens to other experts once
activations are rounded, and a moved choice makes the logits jump, as
tests/test_torch_lm_bf16.py finds for the MoE family; without the MoE the
drift is ~0.05, the Mamba layers' own rounding).  So bfloat16 is held as
there: on 64 sequences, through both prefill routes, the port's drift is
no more than 1.5x the reference's.  The continuous
batcher serves the reference tests' scenarios as the reference does:
outputs and finish order exact in float32, and in a recycled slot each
request inherits the Mamba ``h`` and ``conv`` its slot's earlier
occupants left, on both sides (ROADMAP C9)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_continuous import _both, _serve
from test_torch_lm import DTYPES, F32_LOGITS, _model, _tokens
from test_torch_parity import to_numpy, torch
from torch_lm_cases import BATCHER_SCENARIOS as SCENARIOS

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serve.continuous import ContinuousBatcher as JaxBatcher
from repro.serve.continuous import Request as JaxRequest
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import ContinuousBatcher, Engine, Request

ARCH = "jamba-1.5-large-398b"
F32_STATE = dict(atol=1e-4, rtol=1e-4)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16_drift(arch: str, batch: int, T: int, seed: int = 4, extra=None) -> dict:
    """The bf16 last-token logits' distance from the float32 answer of the
    same (bf16) weights, reference and port, on ``batch`` seeded prompts of
    ``T`` tokens, through ``prefill_forward`` ("full") and through the
    decode step token by token ("step"); ``extra(cfg, batch)`` adds a
    config's other inputs as numpy arrays.  Also the float32 pair's
    distance, which must be ~0."""
    cfgs = {dt: (dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dt),
                 dataclasses.replace(get_config(arch, smoke=True), dtype=dt))
            for dt in ("bfloat16", "float32")}
    tree = jax.tree.map(np.asarray, jlm.init_params(cfgs["bfloat16"][0],
                                                    jax.random.PRNGKey(0)))
    toks = np.random.default_rng(seed).integers(1, cfgs["float32"][1].vocab_size,
                                                (batch, T)).astype(np.int32)
    more = extra(cfgs["float32"][1], batch) if extra else {}
    logits = {}
    for dt, (jcfg, tcfg) in cfgs.items():
        t = tree if dt == "bfloat16" else jax.tree.map(lambda a: a.astype(np.float32), tree)
        jp, tp = jax.tree.map(jnp.asarray, t), lm_params_from_numpy(t, "cpu")
        jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks),
              **{k: jnp.asarray(v) for k, v in more.items()}}
        tb = {"tokens": torch.from_numpy(toks),
              **{k: torch.from_numpy(v) for k, v in more.items()}}
        jfull, _ = jax.jit(jlm.prefill_forward(jcfg))(jp, jb)
        tfull, _ = lm.prefill_forward(tcfg)(tp, tb)
        jeng = JaxEngine(jcfg, jp, max_seq=T, batch_size=batch)
        teng = Engine(tcfg, tp, max_seq=T, batch_size=batch, device="cpu")
        jc, tc = jeng.new_cache(), teng.new_cache()
        if "frames" in more:
            jc = jlm.prefill_encoder(jcfg, jp, jc, jb["frames"])
            tc = lm.prefill_encoder(tcfg, tp, tc, tb["frames"])
        _, jstep = jeng.prefill(jc, jb["tokens"])
        _, tstep = teng.prefill(tc, tb["tokens"])
        logits[dt] = {"full": (np.asarray(jfull), tfull.numpy()),
                      "step": (np.asarray(jstep), tstep.numpy())}
    out = {}
    for route in ("full", "step"):
        (j16, t16), (j32, t32) = logits["bfloat16"][route], logits["float32"][route]
        out[route] = dict(f32=_rel(t32, j32), ref=_rel(j16, j32), port=_rel(t16, j32))
    return out


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_references(smoke):
    want, got = jax_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.block_program() == want.block_program()
    assert got.param_count() == want.param_count()
    assert [m for m, _ in got.block_program()] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [f for _, f in got.block_program()] == ["dense", "moe"] * 4


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_params_has_the_reference_tree_and_the_converter_carries_it(dtype):
    """The port's draws have the reference's leaves, shapes and dtypes
    (``A_log`` and ``D`` float32, the rest in the config's dtype), and the
    reference's own weights arrive bit for bit."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(2)))
    mine = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    carried = lm_params_from_numpy(tree, "cpu")
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    n = 0
    for path, want in leaves:
        got, new = mine, carried
        for p in path:
            got, new = got[p.key], new[p.key]
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype)[6:] == str(new.dtype)[6:] == want.dtype.name, path
        bits = new.view(torch.int16) if want.dtype.name == "bfloat16" else new
        np.testing.assert_array_equal(
            bits.numpy(), want.view(np.int16) if want.dtype.name == "bfloat16" else want)
        n += 1
    mamba = mine["layers"]["pos0"]["mixer"]
    assert mamba["A_log"].dtype == mamba["D"].dtype == torch.float32
    assert mamba["conv_w"].dtype == getattr(torch, dtype)
    assert n == len(leaves)


def test_prefill_forward_matches_the_reference():
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, "float32")
    toks = _tokens(jcfg, 2, 20, seed=4)
    jlog, jkv = jax.jit(jlm.prefill_forward(jcfg))(
        jparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks)})
    tlog, tkv = lm.prefill_forward(tcfg)(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **F32_LOGITS)
    assert set(tkv) == set(jkv) == {"pos4"}           # the one attention position
    for name in ("k", "v"):
        assert tuple(tkv["pos4"][name].shape) == jkv["pos4"][name].shape
        np.testing.assert_allclose(
            to_numpy(tkv["pos4"][name].float()),
            np.asarray(jkv["pos4"][name].astype(jnp.float32)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("route", ["full", "step"])
def test_bf16_drift_from_float32_is_no_larger_than_the_references(route):
    """64 sequences of 16 tokens (the MoE's jumps average out, as in
    tests/test_torch_lm_bf16.py); ``full`` is prefill_forward, ``step`` the
    Engine's token-by-token prefill through the Mamba and attention steps."""
    d = _drift(route)
    assert d["f32"] <= 1e-4
    assert 1e-3 < d["ref"]                  # bf16 really rounds here
    assert d["port"] <= 1.5 * d["ref"], d


_DRIFT = {}


def _drift(route):
    if not _DRIFT:
        _DRIFT.update(bf16_drift(ARCH, 64, 16))
    return _DRIFT[route]


def test_serve_step_matches_the_reference_over_ten_tokens():
    """Logits at every step; then the attention rows and each Mamba
    position's ``h`` and ``conv``."""
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, "float32")
    B, T = 2, 10
    toks = _tokens(jcfg, B, T, seed=5)
    jstep, tstep = jax.jit(jlm.serve_step(jcfg)), lm.serve_step(tcfg)
    jc = jlm.init_cache(jcfg, batch=B, max_seq=16)
    tc = lm.init_cache(tcfg, batch=B, max_seq=16, device="cpu")
    assert {p: {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in c.items()}
            for p, c in tc.items() if p != "len"} == {
        p: {k: (v.shape, v.dtype.name) for k, v in c.items()}
        for p, c in jc.items() if p != "len"}
    for t in range(T):
        jlog, jc = jstep(jparams, jc, jnp.asarray(toks[:, t:t + 1]))
        tlog, tc = tstep(tparams, tc, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **F32_LOGITS)
    assert tc["len"] == int(jc["len"]) == T
    for pos, names in (("pos4", ("k", "v")), ("pos0", ("h", "conv")),
                       ("pos7", ("h", "conv"))):
        for name in names:
            np.testing.assert_allclose(to_numpy(tc[pos][name].float()),
                                       np.asarray(jc[pos][name].astype(jnp.float32)),
                                       **F32_STATE)


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_generate_matches_the_reference(dtype):
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, dtype)
    B, T, new = 2, 6, 8
    prompts = _tokens(jcfg, B, T, seed=6)
    teng = Engine(tcfg, tparams, max_seq=32, batch_size=B, device="cpu")
    got = teng.generate(None, torch.from_numpy(prompts), new)
    assert got.dtype == torch.int32 and got.shape == (B, new)
    assert bool(((got >= 0) & (got < jcfg.vocab_size)).all())
    if dtype == "float32":          # bf16 is held by the drift test above
        jeng = JaxEngine(jcfg, jparams, max_seq=32, batch_size=B)
        _, jlog = jeng.prefill(jeng.new_cache(), jnp.asarray(prompts))
        _, tlog = teng.prefill(teng.new_cache(), torch.from_numpy(prompts))
        np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **F32_LOGITS)
        want = jeng.generate(jax.random.PRNGKey(0), jnp.asarray(prompts), new)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_prefill_equals_prefill_forward_on_the_port():
    """Token by token through the Mamba and attention steps, and the full
    sequence through the chunked scan and the flash kernel: one set of
    logits.  The MoE's capacity is raised until no token drops (a step's
    one token never overflows; 12 at once may)."""
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, "float32")
    tcfg = dataclasses.replace(tcfg, capacity_factor=tcfg.num_experts
                               / tcfg.experts_per_token)
    prompts = torch.from_numpy(_tokens(jcfg, 2, 12, seed=8))
    teng = Engine(tcfg, tparams, max_seq=16, batch_size=2, device="cpu")
    _, step_logits = teng.prefill(teng.new_cache(), prompts)
    full, _ = lm.prefill_forward(tcfg)(tparams, {"tokens": prompts})
    np.testing.assert_allclose(to_numpy(step_logits), to_numpy(full), **F32_LOGITS)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_batcher_matches_the_reference_in_float32(scenario):
    want, got = _both(_model(ARCH, "float32"), scenario)
    assert got == want and len(got) == len(SCENARIOS[scenario][2])


def test_recycled_slot_inherits_the_mamba_state_on_both_sides():
    """Three equal prompts one after another through one slot: each later
    request starts from the ``h`` and ``conv`` the earlier ones left, so
    the three outputs differ, in both packages alike, and the states the
    batchers end with agree."""
    arch, dtype, jcfg, tcfg, jparams, tparams = _model(ARCH, "float32")
    jcb, want = _serve(JaxBatcher, JaxRequest, jcfg, jparams, "recycled_slot",
                       jax.random.PRNGKey(0))
    cb, got = _serve(ContinuousBatcher, Request, tcfg, tparams, "recycled_slot", None,
                     device="cpu")
    assert got == want and len({tuple(out) for _, out in got}) == 3
    for pos in ("pos0", "pos3", "pos7"):
        for name in ("h", "conv"):
            np.testing.assert_allclose(to_numpy(cb.cache[pos][name]),
                                       np.asarray(jcb.cache[pos][name]), **F32_STATE)
        assert float(cb.cache[pos]["h"].abs().max()) > 0
    # a fresh batcher for the third request alone gives another output: the
    # inherited state, not the prompt, made the difference
    _, alone = _serve(ContinuousBatcher, Request, tcfg, tparams,
                      (1, 64, [SCENARIOS["recycled_slot"][2][0]]), None, device="cpu")
    assert alone[0][1] == got[0][1] != got[2][1]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_batcher_finish_order_and_lengths_match_the_reference_in_bf16(scenario):
    want, got = _both(_model(ARCH, "bfloat16"), scenario)
    assert [(rid, len(out)) for rid, out in got] == [(rid, len(out)) for rid, out in want]


def test_first_wave_equals_engine_generate():
    _, _, _, tcfg, _, tparams = _model(ARCH, "float32")
    prompts = np.random.default_rng(3).integers(1, tcfg.vocab_size, (3, 6))
    _, got = _serve(ContinuousBatcher, Request, tcfg, tparams,
                    (3, 32, [(p.tolist(), 5) for p in prompts]), None, device="cpu")
    want = Engine(tcfg, tparams, max_seq=32, batch_size=3, device="cpu").generate(
        None, torch.from_numpy(prompts.astype(np.int32)), 5)
    assert [out for _, out in got] == want.tolist()
