"""The arithmetic of the WKV6 kernel (``csrc/wkv6.cu``), emulated on the
CPU.

The kernel cannot run here, so this file repeats its order of operations in
PyTorch, step for step, and holds the result to chip_smoke phase 10's check,
``|err| <= 1e-5 * (1 + max|x|)`` with x the reference tensor, against the
port's plain version and the reference's ``wkv6_ref``:

* the state split into ``rows_split`` row groups of hd / rows_split rows
  (a thread's rows; its columns do not change the arithmetic);
* a group's out partial for column j: sum_i r_i S_ij over its even rows and
  over its odd rows in two accumulators, each a chain of FMAs in row order,
  then ``fma(v_j, bonus, a0 + a1)``;
* the bonus of a (step, group): sums of ``min(4, rows)`` consecutive
  ``(r_i u_i) k_i`` by FMA, then a tree over those sums;
* out_j: a tree over the groups, ((p0 + p1) + (p2 + p3)) + ...;
* the state update ``S_ij = fma(w_i, S_ij, k_i v_j)``;
* chunks of C steps, the last one ragged, each widened before its steps.

An FMA is emulated in float64 and rounded once to float32.  The emulation is
test code: no path of the port calls it."""
import numpy as np
import pytest

from test_torch_parity import to_numpy, torch

import jax.numpy as jnp
from repro.kernels.rwkv6_scan import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels.rwkv6_scan import wkv6_ref


def chunk_steps(hd):
    return 32 if hd <= 64 else 16              # the kernel's kC


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _tree(x, dim):
    """Pairwise sums over ``dim`` (a power of two long): element 2g with
    2g + 1, then those pairs, and so on, as a shuffle tree over lane bits."""
    dim = dim % x.dim()
    while x.shape[dim] > 1:
        x = x.unflatten(dim, (x.shape[dim] // 2, 2))
        x = x.select(dim + 1, 0) + x.select(dim + 1, 1)
    return x.squeeze(dim)


def emulate_wkv6(w, r, k, v, u, S0=None, rows_split=8):
    """The kernel's scheme on w, r, k, v ``[B, T, H, hd]`` (float32 values),
    u ``[H, hd]``, S0 ``[B, H, hd, hd]`` or None; returns (out, S_T)."""
    B, T, H, hd = r.shape
    rows = hd // rows_split
    vec = min(4, rows)
    C = chunk_steps(hd)
    w, r, k, v = (a.float() for a in (w, r, k, v))
    # S as [B, H, group, row in group, column]
    S = (torch.zeros(B, H, hd, hd) if S0 is None else S0.float().clone())
    S = S.reshape(B, H, rows_split, rows, hd)
    ru = u.float().reshape(H, rows_split, rows)
    out = torch.zeros(B, T, H, hd)
    for t0 in range(0, T, C):                  # a chunk, the last one ragged
        n = min(C, T - t0)
        rc = r[:, t0:t0 + n].reshape(B, n, H, rows_split, rows)
        kc = k[:, t0:t0 + n].reshape(B, n, H, rows_split, rows)
        # the widening's bonus partials: sums of vec elements, then a tree
        sub = torch.zeros(B, n, H, rows_split, rows // vec)
        for e in range(vec):
            idx = slice(e, rows, vec)
            sub = _fma((rc[..., idx] * ru[..., idx]), kc[..., idx], sub)
        bonus = _tree(sub, -1) if rows // vec > 1 else sub[..., 0]
        for c in range(n):
            t = t0 + c
            rt = r[:, t].reshape(B, H, rows_split, rows)
            wt = w[:, t].reshape(B, H, rows_split, rows)
            kt = k[:, t].reshape(B, H, rows_split, rows)
            vt = v[:, t][:, :, None, :]                        # [B, H, 1, hd]
            a = [torch.zeros(B, H, rows_split, hd) for _ in range(2)]
            for i in range(rows):
                a[i % 2] = _fma(rt[..., i, None], S[..., i, :], a[i % 2])
            part = _fma(vt, bonus[:, c][..., None], a[0] + a[1])
            out[:, t] = _tree(part, 2)
            kv = kt[..., None] * vt[:, :, :, None, :]           # [B, H, g, rows, hd]
            S = _fma(wt[..., None], S, kv)
    return out, S.reshape(B, H, hd, hd)


def _inputs(seed, B, T, H, hd, decay, carry):
    """w from phase 10's model decays exp(-exp(-6 + 0.5 N)) or the card
    tests' 0.45 + 0.5 sigmoid(N); r, k, v rounded to bfloat16 as on the main
    path; u ~ 0.5 N; S0 ~ N or None."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(B, T, H, hd))
    w = np.exp(-np.exp(-6 + 0.5 * n)) if decay == "model" else 0.45 + 0.5 / (1 + np.exp(-n))
    rkv = [torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(np.float32))
           .bfloat16().float() for _ in range(3)]
    u = torch.from_numpy((rng.normal(size=(H, hd)) * 0.5).astype(np.float32))
    S0 = (torch.from_numpy(rng.normal(size=(B, H, hd, hd)).astype(np.float32))
          if carry else None)
    return [torch.from_numpy(w.astype(np.float32)), *rkv, u, S0]


def _assert_phase10(got, want):
    err = float((got - want).abs().max())
    rel = err / (1 + float(want.abs().max()))
    assert rel <= 1e-5, f"max |err| {err}, {rel} of 1 + the largest value"


@pytest.mark.parametrize("rows_split", [8, 4])
@pytest.mark.parametrize("decay", ["model", "card"])
def test_emulation_fits_phase10_at_the_rwkv6_7b_head_and_length(decay, rows_split):
    """T = 2048 and hd = 64, two of rwkv6-7b's 64 heads, for the CPU's
    time; rows split 8 is the kernel's blocking at hd 64, and 4, its
    blocking at hd 8 and 128, is held to the same length here."""
    args = _inputs(0, 1, 2048, 2, 64, decay, carry=False)
    got, got_S = emulate_wkv6(*args, rows_split=rows_split)
    want, want_S = wkv6_ref(*args)
    _assert_phase10(got, want)
    _assert_phase10(got_S, want_S)


def test_emulation_fits_phase10_against_the_jax_oracle():
    args = _inputs(1, 1, 2048, 2, 64, "model", carry=False)
    got, got_S = emulate_wkv6(*args)
    want, want_S = jax_wkv6_ref(*(jnp.asarray(to_numpy(a)) for a in args[:5]))
    _assert_phase10(got, torch.from_numpy(np.array(want)))
    _assert_phase10(got_S, torch.from_numpy(np.array(want_S)))


@pytest.mark.parametrize("hd,rows_split", [(8, 4), (128, 4)])
def test_emulation_fits_phase10_at_the_smallest_and_largest_head(hd, rows_split):
    """hd 8 (two rows a group, the bonus without a tree) and hd 128 (32
    rows, a tree of 8 sums), both in the (4, 1) blocking the kernel uses
    there, from a carried state over several chunks."""
    args = _inputs(2, 2, 3 * chunk_steps(hd) + 5, 2, hd, "card", carry=True)
    got, got_S = emulate_wkv6(*args, rows_split=rows_split)
    want, want_S = wkv6_ref(*args)
    _assert_phase10(got, want)
    _assert_phase10(got_S, want_S)


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_emulation_fits_phase10_one_step_past_a_chunk(hd):
    """T = C + 1: a full chunk, then one step in a ragged last chunk."""
    args = _inputs(3, 2, chunk_steps(hd) + 1, 3, hd, "model", carry=True)
    got, got_S = emulate_wkv6(*args)
    want, want_S = wkv6_ref(*args)
    _assert_phase10(got, want)
    _assert_phase10(got_S, want_S)


def test_emulation_of_one_step_from_a_carried_state_matches_the_oracle():
    """The decode shape: T = 1 from a non-zero state."""
    args = _inputs(4, 4, 1, 4, 64, "model", carry=True)
    got, got_S = emulate_wkv6(*args)
    want, want_S = jax_wkv6_ref(*(jnp.asarray(to_numpy(a)) for a in args[:5]),
                                S0=jnp.asarray(to_numpy(args[5])))
    _assert_phase10(got, torch.from_numpy(np.array(want)))
    _assert_phase10(got_S, torch.from_numpy(np.array(want_S)))


def test_tree_sums_in_the_kernels_order():
    x = torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0]])
    assert torch.equal(_tree(x, 1), torch.tensor([255.0]))
    # ((a + b) + (c + d)) in float32: 1e8 + 1 and -1e8 + 1 round to +-1e8,
    # so the tree gives 0 where a sum from the left gives 1
    y = torch.tensor([[1e8, 1.0, -1e8, 1.0]])
    assert float(_tree(y, 1)) == 0.0
