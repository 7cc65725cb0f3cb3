"""The port's Mamba-1 mixer (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``), on the jamba smoke config's widths
with the reference's weights carried across.

The prefill is held to the reference's two discretizations (``fused``
False and True) at S = 5, 128, 256 and 300, within 1e-5 in float32 and
the serving tolerance in bfloat16; a chain of decode steps to the
prefill; and at S = 257, where the reference's reshape raises (ROADMAP
C10), the port runs and equals its own step chain."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_lm import BF16
from test_torch_parity import to_numpy, torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro_torch.models import ssm
from repro_torch.models.convert import lm_params_from_numpy

F32 = dict(atol=1e-5, rtol=1e-5)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg():
    return jax_get_config("jamba-1.5-large-398b", smoke=True)


def _mixer(dtype, seed=0):
    """(jax params, port params) of one Mamba mixer at the smoke widths,
    the reference's draws carried across; ``D`` drawn away from 1 so its
    term shows."""
    cfg = _cfg()
    tree = jax.tree.map(np.asarray, jssm.mamba_init(
        jax.random.PRNGKey(seed), cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state,
        cfg.mamba_d_conv, dtype=JDT[dtype]))
    tree["D"] = np.random.default_rng(seed).normal(size=tree["D"].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, "cpu")


def _u(B, S, dtype, seed=1):
    u = jnp.asarray(np.random.default_rng(seed).normal(size=(B, S, _cfg().d_model))
                    .astype(np.float32), JDT[dtype])
    return u, torch.from_numpy(np.array(u.astype(jnp.float32))).to(TDT[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(to_numpy(got.float()),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)), **tol)


def _kw():
    cfg = _cfg()
    return dict(d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv)


def _step_chain(p, u, cache=None):
    """The port's decode steps over ``u`` ``[B, S, d]`` from ``cache``
    (zeros by default): (outputs ``[B, S, d]``, the last cache)."""
    cfg = _cfg()
    if cache is None:
        cache = ssm.mamba_init_cache(u.shape[0], cfg.mamba_d_inner, cfg.mamba_d_state,
                                     cfg.mamba_d_conv, dtype=u.dtype, device="cpu")
    ys = []
    for t in range(u.shape[1]):
        y, cache = ssm.mamba_step(p, u[:, t:t + 1], cache, **_kw())
        ys.append(y)
    return torch.cat(ys, dim=1), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_init_has_the_reference_leaves_shapes_and_dtypes(dtype):
    cfg = _cfg()
    want = jax.eval_shape(lambda: jssm.mamba_init(
        jax.random.PRNGKey(0), cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state,
        cfg.mamba_d_conv, dtype=JDT[dtype]))
    got = ssm.mamba_init(torch.Generator().manual_seed(0), cfg.d_model,
                         cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv,
                         dtype=TDT[dtype], device="cpu")
    flat_want = {tuple(k.key for k in path): leaf for path, leaf in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {}
    for name, leaf in got.items():
        if isinstance(leaf, dict):
            flat_got.update({(name, k): v for k, v in leaf.items()})
        else:
            flat_got[(name,)] = leaf
    assert set(flat_got) == set(flat_want)
    for key, leaf in flat_want.items():
        assert tuple(flat_got[key].shape) == leaf.shape, key
        assert str(flat_got[key].dtype).replace("torch.", "") == leaf.dtype.name, key
    # the deterministic leaves are the reference's values
    ref = jssm.mamba_init(jax.random.PRNGKey(0), cfg.d_model, cfg.mamba_d_inner,
                          cfg.mamba_d_state, cfg.mamba_d_conv, dtype=JDT[dtype])
    for name in ("A_log", "D", "conv_b"):
        _close(got[name], ref[name], dict(atol=0, rtol=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("S", [5, 128, 256, 300])
def test_mamba_forward_matches_the_reference(S, fused, dtype):
    jp, tp = _mixer(dtype)
    u, ut = _u(2, S, dtype)
    want = jssm.mamba_forward(jp, u, fused=fused, **_kw())
    got = ssm.mamba_forward(tp, ut, **_kw())         # one route for both
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    _close(got, want, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_steps_match_the_reference_from_a_carried_state(dtype):
    """Steps from a non-zero ``h`` and ``conv``, token by token, outputs and
    both states."""
    jp, tp = _mixer(dtype)
    u, ut = _u(2, 6, dtype)
    cfg = _cfg()
    rng = np.random.default_rng(5)
    h0 = rng.normal(size=(2, cfg.mamba_d_inner, cfg.mamba_d_state)).astype(np.float32)
    conv0 = jnp.asarray(rng.normal(size=(2, cfg.mamba_d_conv - 1, cfg.mamba_d_inner))
                        .astype(np.float32), JDT[dtype])
    jc = {"h": jnp.asarray(h0), "conv": conv0}
    tc = {"h": torch.from_numpy(h0),
          "conv": torch.from_numpy(np.array(conv0.astype(jnp.float32))).to(TDT[dtype])}
    tol = F32 if dtype == "float32" else BF16
    for t in range(6):
        jy, jc = jssm.mamba_step(jp, u[:, t:t + 1], jc, **_kw())
        ty, tc = ssm.mamba_step(tp, ut[:, t:t + 1], tc, **_kw())
        _close(ty, jy, tol)
        _close(tc["h"], jc["h"], tol)
        _close(tc["conv"], jc["conv"], tol)
        assert tc["conv"].dtype == TDT[dtype] and tc["h"].dtype == torch.float32


@pytest.mark.parametrize("S", [5, 128, 130])
def test_mamba_step_chain_equals_the_prefill(S):
    """Decode steps from a zero state give the prefill's outputs (float32),
    across a chunk boundary too (130 = 128 + 2)."""
    _, tp = _mixer("float32")
    _, ut = _u(2, S, "float32", seed=3)
    chain, cache = _step_chain(tp, ut)
    np.testing.assert_allclose(to_numpy(chain), to_numpy(ssm.mamba_forward(tp, ut, **_kw())),
                               **F32)
    cfg = _cfg()
    init = ssm.mamba_init_cache(2, cfg.mamba_d_inner, cfg.mamba_d_state,
                                cfg.mamba_d_conv, device="cpu")
    want = jssm.mamba_init_cache(2, cfg.mamba_d_inner, cfg.mamba_d_state,
                                 cfg.mamba_d_conv)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in init.items()} == {
        k: (v.shape, v.dtype.name) for k, v in want.items()}
    assert tuple(cache["h"].shape) == want["h"].shape


def test_mamba_at_257_the_reference_raises_and_the_port_equals_its_step_chain():
    """S = 257 is 2 chunks of 128 and a step over: the reference's prefill
    takes 2 chunks of 128 and cannot reshape them into 257 rows (ROADMAP
    C10); the port's last chunk takes the one step left."""
    jp, tp = _mixer("float32")
    u, ut = _u(2, 257, "float32", seed=4)
    for fused in (False, True):
        with pytest.raises(TypeError, match="reshape"):
            jssm.mamba_forward(jp, u, fused=fused, **_kw())
    got = ssm.mamba_forward(tp, ut, **_kw())
    chain, _ = _step_chain(tp, ut)
    np.testing.assert_allclose(to_numpy(got), to_numpy(chain), **F32)
    # the first 256 rows are the reference's at S = 256
    want = jssm.mamba_forward(jp, u[:, :256], **_kw())
    _close(got[:, :256], want, F32)


def test_mamba_chunk_size_does_not_change_the_prefill():
    """The chunks bound memory and nothing else: chunks of 1, 7 and 128
    steps give one answer."""
    _, tp = _mixer("float32")
    _, ut = _u(2, 40, "float32", seed=6)
    outs = [ssm.mamba_forward(tp, ut, chunk=c, **_kw()) for c in (1, 7, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(to_numpy(o), to_numpy(outs[0]), **F32)

