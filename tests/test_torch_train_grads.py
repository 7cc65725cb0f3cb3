"""Gradients through the port's recurrent and attention pieces on the
CPU: Mamba's differentiable route (``ssm.mamba_forward`` under grad mode,
out of place and checkpointed a chunk at a time) against ``jax.grad`` of
the reference's, and the kernels' ``autograd.Function``s
(``FlashAttentionFn``, ``WKV6Fn``), whose backward is a plain recompute,
against plain autograd of the plain versions.  Inputs from fixed seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import to_numpy, torch
from test_torch_train_loss import _assert_grads, _model

from repro_torch.train.optimizer import tree_leaves, tree_map


@pytest.mark.parametrize("S", [40, 300])
@pytest.mark.parametrize("fused", [False, True])
def test_mamba_backward_matches_the_reference(S, fused):
    """The out-of-place, checkpointed route: the output and the gradients
    of the input and every parameter against ``jax.grad`` of the
    reference's ``mamba_forward`` (both discretizations), one chunk and
    several (the port's chunks of 128 against the reference's 150)."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm

    _, tcfg, _, tparams = _model("jamba-1.5-large-398b")
    pos = next(f"pos{i}" for i, (m, _) in enumerate(tcfg.block_program()) if m == "mamba")
    tp = tree_map(lambda a: a[0].detach().clone(), tparams["layers"][pos]["mixer"])
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tp))
    u = (np.random.default_rng(S).normal(size=(2, S, tcfg.d_model))).astype(np.float32)
    kw = dict(d_state=tcfg.mamba_d_state, d_conv=tcfg.mamba_d_conv)
    gy = np.random.default_rng(S + 1).normal(size=u.shape).astype(np.float32)

    def jloss(p, x):
        y = jssm.mamba_forward(p, x, fused=fused, **kw)
        return jnp.sum(y * gy), y

    (_, jy), (jgp, jgu) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(u))
    tleaves = tree_map(lambda a: a.clone().requires_grad_(), tp)
    tu = torch.from_numpy(u).requires_grad_()
    y = ssm.mamba_forward(tleaves, tu, **kw)
    assert y.grad_fn is not None
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(gy)),
                                [tu, *tree_leaves(tleaves)])
    with torch.no_grad():
        plain = ssm.mamba_forward(tp, torch.from_numpy(u), **kw)
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(to_numpy(y), np.asarray(jy), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(to_numpy(y), to_numpy(plain), rtol=0, atol=1e-5 * scale)
    _assert_grads(grads, [jgu, *jax.tree.leaves(jgp)], f"mamba S={S}")


def _flash_inputs(B, S, Skv, H, Hkv, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g).to(dtype)
    k = torch.randn(B, Skv, Hkv, hd, generator=g).to(dtype)
    v = torch.randn(B, Skv, Hkv, hd, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S, Skv, causal", [(9, 9, True), (9, 13, False), (16, 16, False)])
def test_flash_function_gradient_is_the_plain_versions_autograd(dtype, S, Skv, causal):
    """``FlashAttentionFn`` on CPU tensors: the output is the plain
    version's bit for bit with a ``grad_fn``; the gradients of q, k, v
    (GQA: 4 query heads on 2 kv heads) are plain autograd's of the plain
    version, bit for bit, in the inputs' dtype; under ``no_grad`` it is
    the plain version."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = _flash_inputs(2, S, Skv, 4, 2, 8, dtype, seed=S + Skv)
    go = torch.randn(2, S, 4, 8, generator=torch.Generator().manual_seed(1)).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None and out.dtype == dtype
    got = torch.autograd.grad(out, leaves, go)
    plain_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = flash_attention_ref(*plain_leaves, causal=causal)
    want = torch.autograd.grad(plain, plain_leaves, go)
    assert torch.equal(out.detach(), plain.detach())
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
        assert g.abs().max() > 0
    with torch.no_grad():
        assert torch.equal(fa_ops.flash_attention(q, k, v, causal=causal),
                           flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("rkv_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "carried_state"])
def test_wkv_function_gradient_is_the_plain_versions_autograd(rkv_dtype, with_state):
    """``WKV6Fn`` on CPU tensors: out and S_T are the plain version's bit
    for bit with a ``grad_fn``; the gradients of w, r, k, v, u and S0
    (both outputs weighted) are plain autograd's, bit for bit, in the
    inputs' dtypes, and nonzero."""
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

    g = torch.Generator().manual_seed(3)
    B, T, H, hd = 2, 7, 3, 4
    w = torch.rand(B, T, H, hd, generator=g) * 0.5 + 0.45
    r, k, v = (torch.randn(B, T, H, hd, generator=g).to(rkv_dtype) for _ in range(3))
    u = torch.randn(H, hd, generator=g)
    S0 = torch.randn(B, H, hd, hd, generator=g) if with_state else None
    inputs = [w, r, k, v, u, S0]
    go = torch.randn(B, T, H, hd, generator=g)
    gs = torch.randn(B, H, hd, hd, generator=g)

    def run(fn):
        leaves = [None if t is None else t.clone().requires_grad_() for t in inputs]
        out, S_T = fn(*leaves)
        grads = torch.autograd.grad((out, S_T), [x for x in leaves if x is not None],
                                    (go, gs))
        return out, S_T, grads

    out, S_T, got = run(wkv_ops.wkv6)
    assert out.grad_fn is not None and S_T.grad_fn is not None
    pout, pS, want = run(wkv6_ref)
    assert torch.equal(out.detach(), pout.detach()) and torch.equal(S_T.detach(), pS.detach())
    for gg, ww, t in zip(got, want, [x for x in inputs if x is not None]):
        assert gg.dtype == t.dtype and torch.equal(gg, ww)
        assert gg.abs().max() > 0


def test_knn_wrapper_regret_gradient_is_the_plain_versions_autograd():
    """The third kernel wrapper under grad mode (``RowTop2RegretFn``): the
    indices and regret equal the plain version's, the regret has a
    ``grad_fn`` and its gradient is plain autograd's, bit for bit; without
    a proto that requires grad the direct route returns the same."""
    from repro_torch.kernels.knn_topk import ops as knn_ops
    from repro_torch.kernels.knn_topk.ref import row_top2_regret_ref

    proto = torch.rand(4, 6, 10, generator=torch.Generator().manual_seed(9))
    proto[0, 0, :3] = 0.5                                # a tie
    g = torch.randn(4, 6, generator=torch.Generator().manual_seed(10))
    leaf = proto.clone().requires_grad_()
    best, second, regret = knn_ops.row_top2_regret(leaf)
    assert regret.grad_fn is not None and not best.requires_grad
    plain_leaf = proto.clone().requires_grad_()
    pb, ps, pr = row_top2_regret_ref(plain_leaf)
    assert torch.equal(best, pb) and torch.equal(second, ps)
    assert torch.equal(regret.detach(), pr.detach())
    (got,) = torch.autograd.grad(regret, leaf, g)
    (want,) = torch.autograd.grad(pr, plain_leaf, g)
    assert torch.equal(got, want) and float(got.abs().max()) > 0
    direct = knn_ops.row_top2_regret(proto)
    assert all(torch.equal(a, b) for a, b in zip(direct, (pb, ps, pr.detach())))
