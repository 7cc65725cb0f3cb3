"""The arithmetic of the bfloat16 flash-attention kernel
(``csrc/flash_attention_sm90.cu``), and the tiling of the CUDA-core
kernel's wide form for head dims above 256 (``csrc/flash_attention.cu``),
emulated on the CPU.

The kernel cannot run here, so this file repeats its scheme in PyTorch,
step for step, and holds the result to the tolerances the card tests hold
the kernel to (tests/test_torch_cuda.py):

* tiles of 128 keys, visited in order, and none above a causal diagonal;
* scores Q K^T summed in float32 from bfloat16 inputs;
* the online softmax in base 2, with ``log2(e) / sqrt(hd)`` folded into
  one factor, masked scores at -1e30 (the causal diagonal tile, and keys
  past a ragged S);
* row sums from the float32 ``p``;
* ``p`` carried into P.V as two bfloat16 parts, ``big = bf16(p)`` and
  ``small = bf16(p - big)``, each product summed in float32;
* ``o = acc / max(l, 1e-30)`` rounded to the input dtype.

The wide form's emulation (:func:`emulate_wide`) repeats its slices of
256 output columns, score chunks of 64 columns, key tiles of 32 and the
warps' skipped tiles.  The emulations are test code: no path of the port
calls them."""
import math

import numpy as np
import pytest

from test_torch_cuda import FLASH_CASES, FLASH_TOLS
from test_torch_lm_kernels import _qkv
from test_torch_parity import to_numpy, torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import flash_attention_ref

KEY_TILE = 128                       # the kernel's kKTile


def emulate_sm90(q, k, v, causal=True):
    """The kernel's scheme on q [B, S, H, hd], k, v [B, S, Hkv, hd]."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    c = torch.tensor(math.log2(math.e), dtype=torch.float32) / math.sqrt(hd)
    qf = q.float().reshape(B, S, Hkv, H // Hkv, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    m = torch.full((B, Hkv, H // Hkv, S, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, H // Hkv, S, hd)
    rows = torch.arange(S)[:, None]
    for key0 in range(0, S, KEY_TILE):
        keys = torch.arange(key0, min(key0 + KEY_TILE, S))[None, :]
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
    """The wide form's scheme on q [B, S, H, hd], k, v [B, S, Hkv, hd]: a
    CTA per 64 query rows; per slice of 256 output columns, per key tile
    of 32, the scores summed over chunks of 64 columns, the running max
    and sum recomputed, and P times the slice's V columns added; a warp
    (8 rows) skips a tile its rows cannot see."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    scale = torch.tensor(1.0, dtype=torch.float32) / torch.sqrt(
        torch.tensor(float(hd), dtype=torch.float32))
    out = torch.zeros(B, S, H, hd)
    for b in range(B):
        for h in range(H):
            qb, kb, vb = (t[b, :, i].float() for t, i in
                          ((q, h), (k, h // group), (v, h // group)))
            for q0 in range(0, S, WIDE_Q_TILE):
                rows = q0 + torch.arange(WIDE_Q_TILE)
                k_end = min(S, q0 + WIDE_Q_TILE) if causal else S
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
                        valid = (keys[None] < S) & (~torch.tensor(causal)
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
