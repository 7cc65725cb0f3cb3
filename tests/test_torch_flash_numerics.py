"""The arithmetic of the bfloat16 flash-attention kernel
(``csrc/flash_attention_sm90.cu``), and the tiling of the CUDA-core
kernel's wide form for head dims above 256 (``csrc/flash_attention.cu``),
emulated on the CPU.

The kernel cannot run here, so this file repeats its scheme in PyTorch,
step for step, and holds the result to the tolerances the card tests hold
the kernel to (tests/test_torch_cuda.py):

* tiles of 128 keys, visited in order, and none above a causal diagonal;
  non-causal, keys to a length ``Skv`` of their own (an encoder's memory);
* scores Q K^T summed in float32 from bfloat16 inputs;
* the online softmax in base 2, with ``log2(e) / sqrt(hd)`` folded into
  one factor, masked scores at -1e30 (the causal diagonal tile, and keys
  past a ragged Skv);
* row sums from the float32 ``p``;
* ``p`` carried into P.V as two bfloat16 parts, ``big = bf16(p)`` and
  ``small = bf16(p - big)``, each product summed in float32;
* ``o = acc / max(l, 1e-30)`` rounded to the input dtype.

The wide form's emulation (:func:`emulate_wide`) repeats its slices of
256 output columns, score chunks of 64 columns, key tiles of 32 and the
warps' skipped tiles.  The emulations are test code: no path of the port
calls them.  The plain version at a key length of its own is held to a
numpy softmax and to the reference's oracle, and the reference's
pure-JAX attention, which cuts k/v by q's length, to the plain version
on the first S keys (ROADMAP C10)."""
import math

import numpy as np
import pytest

from test_torch_cuda import FLASH_CASES, FLASH_CROSS_CASES, FLASH_TOLS
from test_torch_lm_kernels import _qkv
from test_torch_parity import to_numpy, torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops

KEY_TILE = 128                       # the kernel's kKTile


def emulate_sm90(q, k, v, causal=True):
    """The kernel's scheme on q [B, S, H, hd], k, v [B, Skv, Hkv, hd]."""
    B, S, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    c = torch.tensor(math.log2(math.e), dtype=torch.float32) / math.sqrt(hd)
    qf = q.float().reshape(B, S, Hkv, H // Hkv, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    m = torch.full((B, Hkv, H // Hkv, S, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, H // Hkv, S, hd)
    rows = torch.arange(S)[:, None]
    for key0 in range(0, Skv, KEY_TILE):
        keys = torch.arange(key0, min(key0 + KEY_TILE, Skv))[None, :]
        s = qf @ kf[..., key0:key0 + KEY_TILE, :].transpose(-1, -2)
        if causal:
            s = s.masked_fill(keys > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        big = p.bfloat16().float()
        small = (p - big).bfloat16().float()
        vt = vf[..., key0:key0 + KEY_TILE, :]
        acc = acc * alpha + big @ vt + small @ vt
        m = m_new
    o = acc / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def _assert_within(got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    bound = rtol * want.float().abs() + atol
    worst = float((err / bound).max())
    assert worst <= 1.0, f"max |err| {float(err.max())}, worst |err|/tol {worst}"


def _inputs(seed, B, S, H, Hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(np.float32)).to(dtype)
            for h in (H, Hkv, Hkv)]


def test_emulation_fits_the_card_tolerance_at_the_llama3_8b_head_layout():
    """S = 2048 and hd = 128 with llama3-8b's 4 query heads per kv head;
    two kv heads of its eight, for the CPU's time and memory."""
    q, k, v = _inputs(0, 1, 2048, 8, 2, 128, torch.bfloat16)
    _assert_within(emulate_sm90(q, k, v), flash_attention_ref(q, k, v),
                   *FLASH_TOLS[torch.bfloat16])


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal", [
    case[:6] for case in FLASH_CASES if case[6] == torch.bfloat16])
def test_emulation_fits_the_card_tolerance_at_every_bf16_card_case(B, S, H, Hkv, hd,
                                                                   causal):
    q, k, v = _inputs(S + hd, B, S, H, Hkv, hd, torch.bfloat16)
    got = emulate_sm90(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_within(got, flash_attention_ref(q, k, v, causal=causal),
                   *FLASH_TOLS[torch.bfloat16])


@pytest.mark.parametrize("S,H,Hkv,hd,causal", [(128, 4, 2, 64, True),
                                               (128, 4, 2, 64, False),
                                               (256, 8, 2, 32, True),
                                               (128, 4, 1, 16, True)])
def test_emulation_matches_the_pallas_kernel_in_float32(S, H, Hkv, hd, causal):
    """float32 inputs through the Pallas kernel (interpret mode, as
    tests/test_kernels.py runs it).  The rounding the scheme adds is that of
    P's second bfloat16 part, at most 2^-17 of p, so an output, a convex
    combination of v rows of |v| < 5, moves by < 4e-5 (read: 6.3e-6)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(7, 2, S, H, Hkv, hd, "float32")
    pallas = np.asarray(jax_flash(qj, kj, vj, causal=causal, q_blk=64, kv_blk=64),
                        np.float32)
    got = to_numpy(emulate_sm90(qt, kt, vt, causal=causal))
    np.testing.assert_allclose(got, pallas, rtol=5e-5, atol=5e-5)


# --------------------------------------------------------------------------
# the CUDA-core kernel's wide form (csrc/flash_attention.cu, hd above 256)
# --------------------------------------------------------------------------
WIDE_Q_TILE, WIDE_ROWS, WIDE_K_TILE = 64, 8, 32   # kQTile, kRows, kKTile
WIDE_CHUNK, WIDE_SLICE = 64, 256                  # kWideChunk, kWideSlice


def _padded(x, rows, cols, r0, c0):
    """``x[r0:r0 + rows, c0:c0 + cols]`` zero-filled past x's edges, as
    the kernel stages a tile."""
    out = torch.zeros(rows, cols)
    part = x[r0:r0 + rows, c0:c0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def emulate_wide(q, k, v, causal=True):
    """The wide form's scheme on q [B, S, H, hd], k, v [B, Skv, Hkv, hd]: a
    CTA per 64 query rows; per slice of 256 output columns, per key tile
    of 32, the scores summed over chunks of 64 columns, the running max
    and sum recomputed, and P times the slice's V columns added; a warp
    (8 rows) skips a tile its rows cannot see."""
    B, S, H, hd = q.shape
    Skv, group = k.shape[1], H // k.shape[2]
    scale = torch.tensor(1.0, dtype=torch.float32) / torch.sqrt(
        torch.tensor(float(hd), dtype=torch.float32))
    out = torch.zeros(B, S, H, hd)
    for b in range(B):
        for h in range(H):
            qb, kb, vb = (t[b, :, i].float() for t, i in
                          ((q, h), (k, h // group), (v, h // group)))
            for q0 in range(0, S, WIDE_Q_TILE):
                rows = q0 + torch.arange(WIDE_Q_TILE)
                k_end = min(S, q0 + WIDE_Q_TILE) if causal else Skv
                for c0 in range(0, hd, WIDE_SLICE):
                    m = torch.full((WIDE_Q_TILE,), -1e30)
                    l = torch.zeros(WIDE_Q_TILE)
                    acc = torch.zeros(WIDE_Q_TILE, WIDE_SLICE)
                    for k0 in range(0, k_end, WIDE_K_TILE):
                        row0 = q0 + WIDE_ROWS * (torch.arange(WIDE_Q_TILE) // WIDE_ROWS)
                        live = (row0 < S) & ~(causal & (row0 + WIDE_ROWS - 1 < k0))
                        s = torch.zeros(WIDE_Q_TILE, WIDE_K_TILE)
                        for d0 in range(0, hd, WIDE_CHUNK):
                            s += (_padded(qb, WIDE_Q_TILE, WIDE_CHUNK, q0, d0)
                                  @ _padded(kb, WIDE_K_TILE, WIDE_CHUNK, k0, d0).T)
                        keys = k0 + torch.arange(WIDE_K_TILE)
                        valid = (keys[None] < Skv) & (~torch.tensor(causal)
                                                    | (keys[None] <= rows[:, None]))
                        sr = torch.where(valid, s * scale, torch.tensor(-1e30))
                        m_cur = torch.maximum(m, sr.max(1).values)
                        alpha = torch.exp(m - m_cur)
                        p = torch.exp(sr - m_cur[:, None])
                        vs = _padded(vb, WIDE_K_TILE, WIDE_SLICE, k0, c0)
                        m = torch.where(live, m_cur, m)
                        l = torch.where(live, l * alpha + p.sum(1), l)
                        acc = torch.where(live[:, None], acc * alpha[:, None] + p @ vs,
                                          acc)
                    o = acc / torch.clamp(l, min=1e-30)[:, None]
                    n_rows, n_cols = min(WIDE_Q_TILE, S - q0), min(WIDE_SLICE, hd - c0)
                    out[b, q0:q0 + n_rows, h, c0:c0 + n_cols] = o[:n_rows, :n_cols]
    return out.to(q.dtype)


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,dtype", [
    (1, 130, 2, 1, 320, True, torch.float32),
    (1, 130, 2, 2, 257, False, torch.float32),
    (2, 37, 2, 1, 512, True, torch.float32),
    (1, 1, 2, 1, 300, True, torch.float32),
    (1, 96, 4, 2, 320, False, torch.bfloat16),
    (1, 70, 2, 1, 512, True, torch.bfloat16),
])
def test_wide_form_emulation_fits_the_card_tolerance(B, S, H, Hkv, hd, causal,
                                                     dtype):
    """The wide form's slicing, chunking and skipping give the function:
    held to the plain version at the card tests' tolerances, at head dims
    that fill one, two and four slices and at ragged S."""
    q, k, v = _inputs(S + hd, B, S, H, Hkv, hd, dtype)
    got = emulate_wide(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_within(got, flash_attention_ref(q, k, v, causal=causal),
                   *FLASH_TOLS[dtype])


# --------------------------------------------------------------------------
# a key length of its own (non-causal: cross-attention over a memory)
# --------------------------------------------------------------------------
def _cross_inputs(seed, B, S, Skv, H, Hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, n, h, hd)).astype(np.float32)).to(dtype)
            for n, h in ((S, H), (Skv, Hkv), (Skv, Hkv))]


def _numpy_attention(q, k, v):
    """Softmax attention in float64 numpy, non-causal, GQA."""
    q, k, v = (to_numpy(t.float()).astype(np.float64) for t in (q, k, v))
    G = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("B,S,Skv,H,Hkv,hd,dtype", FLASH_CROSS_CASES)
def test_plain_version_at_a_key_length_of_its_own_is_a_softmax(B, S, Skv, H, Hkv, hd,
                                                               dtype):
    q, k, v = _cross_inputs(S + Skv, B, S, Skv, H, Hkv, hd, dtype)
    got = fa_ops.flash_attention(q, k, v, causal=False)      # the CPU route
    assert got.dtype == dtype and got.shape == q.shape
    want = torch.from_numpy(_numpy_attention(q, k, v)).float()
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else FLASH_TOLS[dtype]
    _assert_within(got.float(), want, rtol, atol)


@pytest.mark.parametrize("S,Skv", [(64, 256), (128, 37), (16, 16)])
def test_plain_version_at_a_key_length_of_its_own_matches_the_references_oracle(S, Skv):
    """The reference's oracle (``attention_ref``) takes k/v of their own
    length when not causal, and agrees; its pure-JAX attention, the one
    its models call, reads only the first S keys of a longer memory: it
    is the plain version on ``k[:, :S]``, not on k."""
    rng = np.random.default_rng(S * Skv)
    q = rng.normal(size=(2, S, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, Skv, 2, 32)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = to_numpy(flash_attention_ref(tq, tk, tv, causal=False))
    np.testing.assert_allclose(got, np.asarray(attention_ref(q, k, v, causal=False)),
                               rtol=2e-5, atol=2e-5)
    if Skv >= S:
        twin = np.asarray(jattn.flash_attention(q, k, v, causal=False))
        cut = to_numpy(flash_attention_ref(tq, tk[:, :S], tv[:, :S], causal=False))
        np.testing.assert_allclose(twin, cut, rtol=2e-5, atol=2e-5)
        if Skv > S:
            assert float(np.abs(twin - got).max()) > 1e-2
        else:
            np.testing.assert_allclose(twin, got, rtol=2e-5, atol=2e-5)
    else:
        with pytest.raises(TypeError):
            jattn.flash_attention(q, k, v, causal=False)


@pytest.mark.parametrize("B,S,Skv,H,Hkv,hd,dtype", [
    c for c in FLASH_CROSS_CASES if c[6] == torch.bfloat16 and c[5] in (16, 32, 64, 96, 128)])
def test_emulation_at_a_key_length_of_its_own_fits_the_card_tolerance(B, S, Skv, H, Hkv,
                                                                      hd, dtype):
    """The bf16 wgmma kernel's scheme with its key loop run to Skv and the
    last tile's tail masked."""
    q, k, v = _cross_inputs(S + Skv, B, S, Skv, H, Hkv, hd, dtype)
    got = emulate_sm90(q, k, v, causal=False)
    assert got.shape == q.shape
    _assert_within(got, flash_attention_ref(q, k, v, causal=False),
                   *FLASH_TOLS[torch.bfloat16])


@pytest.mark.parametrize("S,Skv,hd,dtype", [(37, 130, 512, torch.bfloat16),
                                            (100, 70, 320, torch.float32)])
def test_wide_form_emulation_at_a_key_length_of_its_own(S, Skv, hd, dtype):
    q, k, v = _cross_inputs(S + hd, 1, S, Skv, 2, 1, hd, dtype)
    got = emulate_wide(q, k, v, causal=False)
    _assert_within(got, flash_attention_ref(q, k, v, causal=False), *FLASH_TOLS[dtype])


def test_wrapper_refuses_causal_attention_at_another_key_length_and_no_keys():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="causal attention needs"):
        fa_ops.flash_attention(q, torch.zeros(1, 9, 2, 16), torch.zeros(1, 9, 2, 16))
    with pytest.raises(ValueError, match="no key"):
        fa_ops.flash_attention(q, torch.zeros(1, 0, 2, 16), torch.zeros(1, 0, 2, 16),
                               causal=False)
    with pytest.raises(ValueError, match="does not fit"):
        fa_ops.flash_attention(q, torch.zeros(1, 9, 2, 16), torch.zeros(1, 8, 2, 16),
                               causal=False)
