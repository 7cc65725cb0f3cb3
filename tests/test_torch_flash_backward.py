"""The flash-attention backward (``FlashAttentionFn.backward``) on the CPU.

* ``flash_attention_bwd_ref``, the backward kernels' plain version, and the
  plain forward's log-sum-exp against ``jax.vjp`` of the reference's
  ``attention_ref`` and ``jax.nn.logsumexp`` of its scores: causal and
  full attention, GQA groups 1, 2 and 4, a ragged S, k/v of a length of
  their own, hd 16, 64 and 96, within the port's float32 tolerance
  1e-5·(1 + max|x|).
* The bf16 tensor-core route's arithmetic (``csrc/flash_attention_bwd.cu``)
  emulated: scores summed in float32 from bf16 inputs, P rebuilt in base 2
  from the log-sum-exp, D = rowsum(P ∘ dP) in float32, and P and dS
  carried into the bf16 products as two bf16 parts.  At llama3-8b's head
  layout its gradients fit the card bound 1e-2·|x| + 2e-3 around the exact
  float32 gradient; the two simpler schemes the kernel does not use (one
  bf16 rounding of P and dS; D read from the bf16 output) do not.
* The meta route: the card route's outputs and workspace as meta tensors,
  the call recorded in ``META_CALLS_BWD`` and not in the forward's
  counters; ``flops_bwd`` is 2.5 × ``flops``.

The kernels themselves are held to the plain version on the card, in
``tests/test_torch_cuda.py``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

CARD_BOUND = (1e-2, 2e-3)            # bf16 (rtol, atol), as tests/test_torch_cuda.py


def _arrays(seed, B, S, Skv, H, Hkv, hd):
    """q, k, v and the output gradient, float32 numpy from a seed."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, n, h, hd)).astype(np.float32)
            for n, h in ((S, H), (Skv, Hkv), (Skv, Hkv), (S, H))]


def _f32_tol(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * (1 + float(np.abs(want).max())), err


def _jax_lse(q, k, causal):
    """logsumexp of the reference's scaled (and masked) scores, [B, H, S]."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    s = jnp.einsum("bqkgd,bskd->bkgqs", q.reshape(B, S, Hkv, H // Hkv, hd), k) / jnp.sqrt(hd)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, k.shape[1]), bool)), s, -jnp.inf)
    return jax.nn.logsumexp(s, axis=-1).reshape(B, H, S)


# (B, S, Skv, H, Hkv, hd, causal)
REF_CASES = [
    (2, 37, 37, 4, 4, 16, True),      # G 1, ragged S
    (2, 64, 64, 4, 2, 64, True),      # G 2
    (1, 37, 37, 8, 2, 96, True),      # G 4, ragged, hd 96
    (2, 64, 64, 8, 2, 64, False),     # full attention
    (2, 37, 100, 4, 2, 16, False),    # a longer memory
    (1, 64, 37, 4, 1, 96, False),     # a shorter memory, G 4
    (2, 37, 37, 4, 4, 96, False),     # G 1, full, ragged
]


@pytest.mark.parametrize("B,S,Skv,H,Hkv,hd,causal", REF_CASES)
def test_plain_backward_and_lse_match_the_reference(B, S, Skv, H, Hkv, hd, causal):
    q, k, v, do = _arrays(S * 131 + Skv + hd, B, S, Skv, H, Hkv, hd)
    out, vjp = jax.vjp(lambda a, b, c: attention_ref(a, b, c, causal=causal), q, k, v)
    jgrads = vjp(jnp.asarray(do))
    o, lse = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                 with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    _f32_tol(o.numpy(), out)
    _f32_tol(lse.numpy(), _jax_lse(q, k, causal))
    grads = flash_attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)), lse,
                                    torch.from_numpy(do), causal=causal)
    for g, w, t in zip(grads, jgrads, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == t.shape
        assert float(g.abs().max()) > 0
        _f32_tol(g.numpy(), w)


@pytest.mark.parametrize("causal", [True, False])
def test_the_functions_cpu_route_agrees_with_the_kernels_plain_version(causal):
    """``FlashAttentionFn`` on CPU tensors (the gradient's plain version,
    autograd of the plain forward) and ``flash_attention_bwd_ref`` from the
    log-sum-exp the Function saved agree within the float32 tolerance; the
    card's counters do not move."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(5, 2, 37, 37, 8, 2, 64))
    before = (fa_ops.LAUNCHES, fa_ops.LAUNCHES_BWD, dict(fa_ops.META_CALLS_BWD))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, causal=causal)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4 and saved[3].shape == (2, 8, 37)
    got = torch.autograd.grad(out, leaves, do)
    want = flash_attention_bwd_ref(q, k, v, saved[3], do, causal=causal)
    for g, w in zip(got, want):
        _f32_tol(g.numpy(), w.numpy())
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_BWD, fa_ops.META_CALLS_BWD) == before


# --------------------------------------------------------------------------
# the bf16 tensor-core route's arithmetic
# --------------------------------------------------------------------------
def _bf16_parts(x, split):
    """x as the kernel hands it to the bf16 tensor cores: bf16(x), plus
    bf16(x - bf16(x)) when split."""
    big = x.bfloat16().float()
    return big + (x - big).bfloat16().float() if split else big


def emulate_tc_backward(q, k, v, lse, do, causal=True, split=True, o=None):
    """The tensor-core route's scheme on bf16 q [B, S, H, hd], k, v
    [B, Skv, Hkv, hd], dO and the float32 lse: S = Q Kᵀ in float32,
    P = 2^(c S - lse log2 e) with c = log2(e) / sqrt(hd), dP = dO Vᵀ,
    D = rowsum(P ∘ dP) (or, given ``o``, rowsum(dO ∘ o)), dS = P ∘ (dP - D),
    then dV = Pᵀ dO, dK = dSᵀ Q / sqrt(hd), dQ = dS K / sqrt(hd) with P and
    dS as bf16 parts, rounded to bf16 at the end."""
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    c = torch.tensor(math.log2(math.e), dtype=torch.float32) / math.sqrt(hd)
    qf, dof = (t.float().reshape(B, S, Hkv, G, hd) for t in (q, do))
    kf, vf = k.float(), v.float()
    lse2 = (lse * math.log2(math.e)).reshape(B, Hkv, G, S, 1)
    p = torch.exp2(torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * c - lse2)
    if causal:
        p = p.masked_fill(~torch.ones(S, Skv, dtype=torch.bool).tril(), 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    if o is None:
        D = (p * dp).sum(-1, keepdim=True)
    else:
        D = (dof * o.float().reshape(B, S, Hkv, G, hd)).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = _bf16_parts(p * (dp - D), split)
    dv = torch.einsum("bkgqs,bqkgd->bskd", _bf16_parts(p, split), dof)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) / math.sqrt(hd)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) / math.sqrt(hd)
    return dq.reshape(B, S, H, hd).bfloat16(), dk.bfloat16(), dv.bfloat16()


def _worst(got, want):
    """max |got - want| / (1e-2·|want| + 2e-3)."""
    rtol, atol = CARD_BOUND
    err = (got.float() - want.float()).abs()
    return float((err / (rtol * want.float().abs() + atol)).max())


def _bf16_case(seed, B, S, Skv, H, Hkv, hd, causal):
    """bf16 inputs, the bf16 output and float32 lse of the plain forward,
    and the exact float32 gradient of the bf16 inputs."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _arrays(seed, B, S, Skv, H, Hkv, hd))
    o, lse = flash_attention_ref(q, k, v, causal=causal, with_lse=True)
    _, lse32 = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                   with_lse=True)
    exact = flash_attention_bwd_ref(q.float(), k.float(), v.float(), lse32, do.float(),
                                    causal=causal)
    return (q, k, v, do, o, lse), exact


@pytest.fixture(scope="module")
def llama_layout():
    """S = 2048, hd = 128 and llama3-8b's 4 query heads a kv head; two kv
    heads of its eight, for the CPU's time and memory."""
    return _bf16_case(0, 1, 2048, 2048, 8, 2, 128, True)


def test_emulation_fits_the_card_bound_at_the_llama3_8b_head_layout(llama_layout):
    (q, k, v, do, _, lse), exact = llama_layout
    worst = [_worst(g, w) for g, w in zip(emulate_tc_backward(q, k, v, lse, do), exact)]
    assert max(worst) <= 1.0, worst


@pytest.mark.parametrize("scheme", ["one_rounding", "d_from_the_output"])
def test_the_simpler_schemes_miss_the_card_bound(llama_layout, scheme):
    """Why the kernel splits P and dS and sums D from P ∘ dP: one bf16
    rounding of each (2^-9 of x), or D from the bf16 output's rounding,
    puts a gradient past the bound at this layout."""
    (q, k, v, do, o, lse), exact = llama_layout
    kw = dict(split=False) if scheme == "one_rounding" else dict(o=o)
    worst = [_worst(g, w) for g, w in zip(emulate_tc_backward(q, k, v, lse, do, **kw), exact)]
    assert max(worst) > 1.0, worst


@pytest.mark.parametrize("B,S,Skv,H,Hkv,hd,causal", [
    (2, 200, 200, 4, 2, 64, True),     # ragged S
    (2, 130, 130, 8, 2, 32, False),
    (1, 64, 256, 16, 16, 64, False),   # seamless's cross-attention layout
    (2, 200, 37, 4, 2, 128, False),    # a shorter memory
    (3, 37, 37, 4, 1, 16, True),
    (1, 256, 256, 8, 2, 96, True),
])
def test_emulation_fits_the_card_bound(B, S, Skv, H, Hkv, hd, causal):
    (q, k, v, do, _, lse), exact = _bf16_case(S + Skv + hd, B, S, Skv, H, Hkv, hd, causal)
    got = emulate_tc_backward(q, k, v, lse, do, causal=causal)
    for g, w in zip(got, exact):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
    worst = [_worst(g, w) for g, w in zip(got, exact)]
    assert max(worst) <= 1.0, worst


# --------------------------------------------------------------------------
# the meta route
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,Skv,H,Hkv,hd,causal,dtype", [
    (2, 16, 16, 4, 2, 64, True, torch.bfloat16),
    (1, 8, 24, 4, 4, 96, False, torch.float32),
    (1, 5, 5, 2, 1, 40, True, torch.bfloat16),       # zero-padded to 64
    (1, 5, 5, 2, 1, 300, True, torch.float32),       # the wide head dims
])
def test_backward_meta_route(B, S, Skv, H, Hkv, hd, causal, dtype):
    q, k, v, do = (torch.empty(s, dtype=dtype, device="meta") for s in (
        (B, S, H, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd), (B, S, H, hd)))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    fa_ops.META_CALLS.clear()
    fa_ops.META_CALLS_BWD.clear()
    before = (fa_ops.LAUNCHES, fa_ops.LAUNCHES_BWD, dict(fa_ops.LAUNCHES_BWD_BY_CALL))
    got = torch.autograd.grad(fa_ops.flash_attention(*leaves, causal=causal), leaves, do)
    for g, t in zip(got, (q, k, v)):
        assert (g.device.type, g.shape, g.dtype) == ("meta", t.shape, dtype)
    key = (B, S, Skv, H, Hkv, hd, causal, dtype)
    assert fa_ops.META_CALLS == {key: 1} and fa_ops.META_CALLS_BWD == {key: 1}
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_BWD, fa_ops.LAUNCHES_BWD_BY_CALL) == before
    # no grad: the forward alone
    fa_ops.flash_attention(q.detach(), k.detach(), v.detach(), causal=causal)
    assert fa_ops.META_CALLS == {key: 2} and fa_ops.META_CALLS_BWD == {key: 1}
    fa_ops.META_CALLS.clear()
    fa_ops.META_CALLS_BWD.clear()


def test_backward_meta_route_allocates_the_card_routes_workspace():
    """Under the dry-run's counter the meta backward's storages are the
    card route's: the D workspace [B, H, S] in float32 and dq, dk, dv."""
    from repro_torch.launch import dryrun

    B, S, H, Hkv, hd = 2, 64, 8, 2, 64
    q, k, v, do = (torch.empty(s, dtype=torch.bfloat16, device="meta")
                   for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), (B, S, H, hd)))
    lse = torch.empty(B, H, S, device="meta")
    counter = dryrun.StepCounter()
    counter.track((q, k, v, do, lse))
    with counter:
        grads = fa_ops._backward(q, k, v, lse, do, True)
    args = sum(t.nbytes for t in (q, k, v, do, lse))
    made = B * H * S * 4 + sum(g.nbytes for g in grads)
    assert counter.peak_bytes == args + made
    assert counter.flops == 0
    fa_ops.META_CALLS_BWD.clear()


@pytest.mark.parametrize("S,Skv,causal", [(2048, 2048, True), (37, 37, True), (64, 100, False)])
def test_backward_work_formulas(S, Skv, causal):
    B, H, Hkv, hd = 2, 32, 8, 128
    assert 2 * fa_ops.flops_bwd(B, S, Skv, H, hd, causal) == 5 * fa_ops.flops(
        B, S, Skv, H, hd, causal)
    assert fa_ops.bytes_moved_bwd(B, S, Skv, H, Hkv, hd, torch.bfloat16) == (
        2 * (3 * B * S * H * hd + 4 * B * Skv * Hkv * hd) + 4 * B * H * S)


def test_backward_bound_at_llama3_8b_training_microbatch():
    """172 GFLOP, 0.174 ms at 989 TFLOP/s: q [2, 2048, 32, 128], 8 kv heads,
    causal."""
    flops = fa_ops.flops_bwd(2, 2048, 2048, 32, 128, True)
    assert flops == 10 * 128 * 2 * 32 * 2048 * 2049 // 2
    assert round(flops / 989e12 * 1e3, 3) == 0.174
