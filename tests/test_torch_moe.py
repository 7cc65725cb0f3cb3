"""The port's routed MoE FFN (``repro_torch.models.ffn.moe_ffn``) against
the reference's (``repro.models.ffn.moe_ffn``) on the same input bits.

The reference's routing (each choice's expert, its slot in the expert's
buffer and the ``keep`` mask) is internal to its ``moe_ffn``: the tests
read it from the first ``jax.vmap`` the function makes (``dispatch_one``)
through a stand-in for the module's ``jax``, and hold the port's
``moe_route`` to it exactly.  Outputs and the aux loss agree within 1e-5
in float32 and at the serving tolerance in bfloat16 (tests/test_serve.py:
atol 0.08, rtol 0.05).  The inputs are seeded continuous draws, so the
router's probabilities hold no exact tie that ``torch.topk`` and
``lax.top_k`` could order differently."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import to_numpy, torch

from repro.configs import get_config as jax_get_config
from repro.models import ffn as jffn
from repro_torch.models import ffn
from repro_torch.models.convert import lm_params_from_numpy

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=0.08, rtol=0.05)          # tests/test_serve.py
# (config whose MoE widths are used, batch, sequence)
CASES = {"granite": ("granite-moe-3b-a800m", 2, 16),
         "qwen2-moe-shared": ("qwen2-moe-a2.7b", 2, 16),
         "decode": ("granite-moe-3b-a800m", 3, 1)}


class _CaptureVmap:
    """Stands in for ``jax`` inside the reference's ffn module and keeps
    what the first vmapped function (``dispatch_one``) returns."""

    def __init__(self):
        self.dispatch = None

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *args, **kwargs):
        mapped = jax.vmap(fn, *args, **kwargs)

        def run(*a):
            out = mapped(*a)
            if self.dispatch is None:
                self.dispatch = out
            return out
        return run


def _layer(arch, dtype, seed=0, router_bias=None):
    """(cfg, numpy params, port params) of one MoE layer at ``arch``'s
    smoke widths, drawn by the reference's ``moe_init``."""
    cfg = jax_get_config(arch, smoke=True)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tree = jax.tree.map(np.asarray, jffn.moe_init(
        jax.random.PRNGKey(seed), cfg.d_model, cfg.d_ff, cfg.num_experts,
        cfg.num_shared_experts, dtype=jdt))
    if router_bias is not None:
        # one expert's router column grows, and with the inputs' positive
        # mean (``_x(shift=)``) every token picks it
        w = tree["router"]["w"].copy()
        w[:, router_bias] += 1.0
        tree["router"]["w"] = w
    return cfg, tree, lm_params_from_numpy(tree, "cpu")


def _x(cfg, B, S, dtype, seed=1, shift=0.0):
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    x += shift
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.float32 if dtype == "float32" else torch.bfloat16)
    return jx, tx


def _run_both(monkeypatch, cfg, tree, tparams, jx, tx, capacity_factor=None):
    kw = dict(experts_per_token=cfg.experts_per_token,
              capacity_factor=capacity_factor or cfg.capacity_factor,
              router_aux_coef=cfg.router_aux_coef)
    capture = _CaptureVmap()
    monkeypatch.setattr(jffn, "jax", capture)
    jout, jaux = jffn.moe_ffn(jax.tree.map(jnp.asarray, tree), jx, **kw)
    monkeypatch.undo()
    tout, taux = ffn.moe_ffn(tparams, tx, **kw)
    route = ffn.moe_route(tparams, tx, experts_per_token=kw["experts_per_token"],
                          capacity_factor=kw["capacity_factor"])
    _, slot, keep, flat_e, _ = capture.dispatch
    return (jout, jaux, np.asarray(flat_e), np.asarray(slot), np.asarray(keep)), (
        tout, taux, route)


def _check(ref, got, tol):
    jout, jaux, flat_e, slot, keep = ref
    tout, taux, route = got
    np.testing.assert_array_equal(route.expert.numpy(), flat_e)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    np.testing.assert_array_equal(route.slot.numpy(), slot)
    assert tout.dtype == {jnp.float32: torch.float32,
                          jnp.bfloat16: torch.bfloat16}[jout.dtype.type]
    np.testing.assert_allclose(to_numpy(tout.float()),
                               np.asarray(jout.astype(jnp.float32)), **tol)
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_the_reference(monkeypatch, case, dtype):
    arch, B, S = CASES[case]
    cfg, tree, tparams = _layer(arch, dtype)
    jx, tx = _x(cfg, B, S, dtype)
    ref, got = _run_both(monkeypatch, cfg, tree, tparams, jx, tx)
    _check(ref, got, F32 if dtype == "float32" else BF16)
    cap = int(cfg.capacity_factor * S * cfg.experts_per_token / cfg.num_experts) + 1
    assert got[2].cap == cap
    assert ("shared" in tparams) == (cfg.num_shared_experts > 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_drops_what_overflows_an_experts_capacity(monkeypatch, dtype):
    """A router biased to expert 3 sends every token there: past ``cap``
    choices go to the drop bin and contribute nothing, in both packages."""
    cfg, tree, tparams = _layer("granite-moe-3b-a800m", dtype, router_bias=3)
    B, S = 2, 16
    jx, tx = _x(cfg, B, S, dtype, shift=1.0)
    ref, got = _run_both(monkeypatch, cfg, tree, tparams, jx, tx)
    _check(ref, got, F32 if dtype == "float32" else BF16)
    route = got[2]
    assert int((route.expert == 3).sum()) == B * S      # every token chose it
    # expert 3 is every token's first choice, so its rank is the token's
    # index: tokens from cap on are dropped there
    dropped = ~route.keep & (route.expert == 3)
    assert int(dropped.sum()) == B * (S - route.cap) > 0
    assert bool((route.slot[~route.keep] == route.cap).all())


def test_moe_ffn_with_no_capacity_slack_matches_the_reference(monkeypatch):
    """capacity_factor 0.5: cap below the balanced load, drops in many
    experts at once."""
    cfg, tree, tparams = _layer("qwen2-moe-a2.7b", "float32", seed=4)
    jx, tx = _x(cfg, 2, 24, "float32", seed=5)
    ref, got = _run_both(monkeypatch, cfg, tree, tparams, jx, tx, capacity_factor=0.5)
    _check(ref, got, F32)
    assert int((~got[2].keep).sum()) > 0


def test_moe_combine_adds_the_choices_in_k_order_and_repeats_bit_for_bit():
    """Two runs give the same bits, and the combine is the fixed-order sum
    over k of the kept, weighted expert outputs."""
    cfg, _, tparams = _layer("granite-moe-3b-a800m", "bfloat16", seed=2)
    _, tx = _x(cfg, 2, 16, "bfloat16", seed=3)
    kw = dict(experts_per_token=cfg.experts_per_token)
    a, _ = ffn.moe_ffn(tparams, tx, **kw)
    b, _ = ffn.moe_ffn(tparams, tx, **kw)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    # per choice, the expert's SwiGLU of its token, weighted, summed in k order
    r = ffn.moe_route(tparams, tx, **kw)
    K = cfg.experts_per_token
    want = torch.zeros_like(tx)
    for k in range(K):
        e = r.expert.view(2, 16, K)[:, :, k]
        keep = r.keep.view(2, 16, K)[:, :, k]
        g, u, dn = tparams["gate"][e], tparams["up"][e], tparams["down"][e]
        y = torch.einsum("bsf,bsfd->bsd", torch.nn.functional.silu(
            torch.einsum("bsd,bsdf->bsf", tx, g)) * torch.einsum("bsd,bsdf->bsf", tx, u), dn)
        y = torch.where(keep[..., None], y, 0.0)
        want = want + y * r.top_w[:, :, k:k + 1].to(y.dtype)
    np.testing.assert_allclose(a.float().numpy(), want.float().numpy(), **BF16)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_moe_bf16_rounding_is_no_coarser_than_the_references(arch):
    """One layer at d_model 256 on 16 x 64 tokens, the same bf16 weights and
    inputs, no token dropped (the routing reads a float32 product of the
    same bits, so it is one routing in all three runs): the port's bf16
    output lies within 1.5x the reference's distance from the float32
    answer."""
    cfg = jax_get_config(arch, smoke=True)
    d, d_ff = 256, 512
    tree = jax.tree.map(np.asarray, jffn.moe_init(
        jax.random.PRNGKey(0), d, d_ff, cfg.num_experts, cfg.num_shared_experts,
        dtype=jnp.bfloat16))
    x = np.random.default_rng(1).normal(size=(16, 64, d)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    kw = dict(experts_per_token=cfg.experts_per_token,
              capacity_factor=cfg.num_experts / cfg.experts_per_token)
    j32, _ = jffn.moe_ffn(jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree),
                          jnp.asarray(x), **kw)
    j16, _ = jffn.moe_ffn(jax.tree.map(jnp.asarray, tree),
                          jnp.asarray(x, jnp.bfloat16), **kw)
    t16, _ = ffn.moe_ffn(lm_params_from_numpy(tree, "cpu"),
                         torch.from_numpy(x).bfloat16(), **kw)
    j32 = np.asarray(j32)

    def rel(a):
        return float(np.linalg.norm(a - j32) / np.linalg.norm(j32))
    ref = rel(np.asarray(j16.astype(jnp.float32)))
    assert 1e-3 < ref                      # bf16 really rounds here
    assert rel(t16.float().numpy()) <= 1.5 * ref


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_moe_init_has_the_reference_tree_shapes_dtypes_and_scales(arch, smoke):
    cfg = jax_get_config(arch, smoke=smoke)
    if not smoke:
        # the full widths' leaves are large: one expert's worth is enough for
        # the scales, the shapes come from eval_shape below
        cfg = dataclasses.replace(cfg, num_experts=2)
    want = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: jffn.moe_init(jax.random.PRNGKey(0), cfg.d_model, cfg.d_ff,
                              cfg.num_experts, cfg.num_shared_experts)))[0]
    got = ffn.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff,
                       cfg.num_experts, cfg.num_shared_experts, device="cpu")
    assert len(want) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in want:
        t = got
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == leaf.dtype.name, path
    assert got["router"]["w"].dtype == torch.float32
    assert abs(float(got["router"]["w"].std()) - 0.02) < 2e-3
    for name in ("gate", "up", "down"):
        std = float(got[name].float().std()) * math.sqrt(cfg.d_model)
        assert abs(std - 1.0) < 0.05, name
    if cfg.num_shared_experts:
        assert got["shared"]["gate"]["w"].shape == (
            cfg.d_model, cfg.num_shared_experts * cfg.d_ff)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_serving_computes_no_aux_loss_and_gives_moe_ffns_output(monkeypatch, arch):
    """The serving path's FFN (``lm._run_ffn``) is ``moe_route`` then
    ``moe_apply``: ``moe_ffn``'s output bit for bit, and ``moe_aux`` is
    never called, in prefill or in a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    _, tparams = _layer(arch, "float32", seed=4)[1:]
    _, tx = _x(cfg, 2, 16, "float32", seed=5)
    want, _ = ffn.moe_ffn(tparams, tx, experts_per_token=cfg.experts_per_token,
                          capacity_factor=cfg.capacity_factor)

    def no_aux(*args, **kwargs):
        raise AssertionError("serving computed the aux loss")
    monkeypatch.setattr(ffn, "moe_aux", no_aux)
    assert torch.equal(lm._run_ffn(tparams, tx, cfg, "moe"), want)
    params = lm.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(7))
    logits, _ = lm.prefill_forward(cfg)(params, {"tokens": tokens})
    cache = lm.init_cache(cfg, batch=2, max_seq=4, device="cpu")
    step_logits, _ = lm.serve_step(cfg)(params, cache, tokens[:, :1])
    assert torch.isfinite(logits).all() and torch.isfinite(step_logits).all()
