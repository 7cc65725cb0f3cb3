"""The K-NN row-reduction kernel (``csrc/knn_topk.cu``), emulated on the CPU.

The kernel cannot run here, so this file repeats in numpy what it does, and
holds the result, instance by instance, to the reference's Pallas kernel
(``repro.kernels.knn_topk.row_top2_regret``, in interpret mode):

* m <= 16: a CTA of kRows threads stages a tile of kRows rows (kRows * m
  contiguous floats) into shared memory: a scalar head of up to 3 floats up
  to the first 16-byte boundary, the aligned body as float4s (thread t,
  iteration i takes float4 t + i * kRows), a scalar tail of up to 3; the
  tile lies in shared memory at the base's offset within 16 bytes.  The
  emulation asserts that every float4 is aligned in both memories, that
  the copy reads only the tile's own floats and writes each exactly once,
  and that a row read as float2/float4 is aligned.  The last tile is
  ragged.
* the two passes over a row's registers, ``row_max``: the leftmost maximum
  under ``beats(v, cur) = !(v <= cur) & (cur == cur)`` (v > cur, or v NaN
  and cur not), as a tree of pairs (j, j + stride) for stride 1, 2, 4, ...,
  the right one taken only if it beats the left; then the same with the
  best column read as -1e30; regret = 2 * (best - second) in float32.
* m > 16: a thread a row, chunks of kChunk columns, -inf past m; a chunk's
  maximum replaces the running one only if it beats it; the masked pass
  reads the chunks again.

kRows and kChunk are read from the source.  The emulation is test code:
nothing in the port calls it."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.knn_topk import row_top2_regret as jax_top2
from repro_torch.kernels.knn_topk.ref import edge_rows

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "knn_topk" / "csrc" / "knn_topk.cu").read_text()
K_ROWS = int(re.search(r"constexpr int kRows = (\d+);", SOURCE).group(1))
K_CHUNK = int(re.search(r"constexpr int kChunk = (\d+);", SOURCE).group(1))
NEG = np.float32(-1e30)


def _beats(v, cur):
    """The kernel's ``!(v <= cur) & (cur == cur)``: v > cur, or v NaN and
    cur not."""
    with np.errstate(invalid="ignore"):
        return ~(v <= cur) & (cur == cur)


def _row_max(v, masked):
    """The kernel's ``row_max`` on v ``[rows, N]``: column ``masked`` (per
    row) read as -1e30, then a tree of pairs j, j + stride (stride 1, 2,
    4, ...), the right one taken only if it beats the left."""
    n = v.shape[1]
    val = np.where(np.arange(n) == np.asarray(masked)[:, None], NEG, v)
    idx = np.broadcast_to(np.arange(n), val.shape).copy()
    stride = 1
    while stride < n:
        for j in range(0, n - stride, 2 * stride):
            b = _beats(val[:, j + stride], val[:, j])
            val[:, j] = np.where(b, val[:, j + stride], val[:, j])
            idx[:, j] = np.where(b, idx[:, j + stride], idx[:, j])
        stride *= 2
    return val[:, 0], idx[:, 0]


def _finish(bv, bi, sv, si):
    with np.errstate(invalid="ignore", over="ignore"):
        regret = np.float32(2.0) * (bv - sv)
    return bi.astype(np.int32), si.astype(np.int32), regret.astype(np.float32)


def _tile(flat, src, nrows, m):
    """One CTA of the m <= 16 kernel on the tile at float ``src`` of
    ``flat`` (flat[0] on a 16-byte boundary): its rows' registers."""
    n = nrows * m
    shift = src % 4
    head = min((4 - shift) % 4, n)
    nvec = (n - head) // 4
    tail = head + 4 * nvec
    smem = np.full(K_ROWS * m + 4, np.float32(7.0))
    writes = np.zeros(K_ROWS * m + 4, np.int64)
    dst = shift
    t = np.arange(K_ROWS)
    for i in range((K_ROWS * m // 4 + K_ROWS - 1) // K_ROWS):
        k = t + i * K_ROWS
        k = k[k < nvec]
        g, s = src + head + 4 * k, dst + head + 4 * k
        assert np.all(g % 4 == 0) and np.all(s % 4 == 0)
        for c in range(4):
            smem[s + c] = flat[g + c]
            writes[s + c] += 1
    for lo, count in ((0, head), (tail, n - tail)):
        th = t[t < count]
        assert np.all(src + lo + th < src + n)
        smem[dst + lo + th] = flat[src + lo + th]
        writes[dst + lo + th] += 1
    assert np.all(writes[dst:dst + n] == 1) and writes.sum() == n
    vec = 4 if m % 4 == 0 else 2 if m % 2 == 0 else 1
    starts = dst + np.arange(nrows) * m
    if vec > 1 and shift % vec == 0:
        assert np.all(starts % vec == 0)
    return smem[starts[:, None] + np.arange(m)]


def emulate_top2(flat, off, rows, m):
    """The kernel on the contiguous ``[rows, m]`` tensor at float ``off`` of
    ``flat``; returns (best, second, regret) as it stores them."""
    out = []
    if m <= K_CHUNK:
        for row0 in range(0, rows, K_ROWS):
            nrows = min(K_ROWS, rows - row0)
            v = _tile(flat, off + row0 * m, nrows, m)
            bv, bi = _row_max(v, np.full(nrows, -1))
            sv, si = _row_max(v, bi)
            out.append(_finish(bv, bi, sv, si))
    else:
        p = flat[off:off + rows * m].reshape(rows, m)
        padded = np.full((rows, -(-m // K_CHUNK) * K_CHUNK), -np.inf, np.float32)
        padded[:, :m] = p
        chunks = [(c, padded[:, c:c + K_CHUNK]) for c in range(0, m, K_CHUNK)]
        bv, bi = p[:, 0], np.zeros(rows, np.int64)
        for c, v in chunks:
            cv, ci = _row_max(v, np.full(rows, -1))
            b = _beats(cv, bv)
            bv, bi = np.where(b, cv, bv), np.where(b, c + ci, bi)
        sv, si = np.where(bi == 0, NEG, p[:, 0]), np.zeros(rows, np.int64)
        for c, v in chunks:
            cv, ci = _row_max(v, bi - c)
            b = _beats(cv, sv)
            sv, si = np.where(b, cv, sv), np.where(b, c + ci, si)
        out.append(_finish(bv, bi, sv, si))
    return tuple(np.concatenate(parts) for parts in zip(*out))


def _placed(p, off):
    """p ``[rows, m]`` copied to float ``off`` of a fresh flat buffer."""
    flat = np.full(off + p.size + 3, np.float32(-5.0))
    flat[off:off + p.size] = p.reshape(-1)
    return flat


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=0, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("m", [2, 3, 4, 10, 16, 17, 33])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_emulation_matches_pallas_kernel_on_edge_rows(m, off):
    names, rows = edge_rows(m)
    p = rows.numpy()
    got = emulate_top2(_placed(p, off), off, p.shape[0], m)
    for i, name in enumerate(names):
        want = jax_top2(jnp.asarray(p[i:i + 1]), row_blk=16)
        try:
            _assert_same(tuple(g[i:i + 1] for g in got), want)
        except AssertionError as err:
            raise AssertionError(f"edge row {name} (m={m}, off={off})") from err


def _sweep_proto(rows, m, seed):
    """Uniform rows, a third of them quantized (ties), every edge row
    spliced in where there is room."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(size=(rows, m)).astype(np.float32)
    tied = rng.uniform(size=rows) < 1 / 3
    p[tied] = np.round(p[tied] * 3) / 3
    edges = edge_rows(m)[1].numpy()
    at = rng.permutation(rows)[:min(rows, edges.shape[0])]
    p[at] = edges[:at.size]
    return p


@pytest.mark.parametrize("rows", [1, 127, 128, 129, 800, 25600])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("m", [10, 33])
def test_emulation_matches_pallas_kernel_over_tiles_and_offsets(rows, off, m):
    p = _sweep_proto(rows, m, seed=rows + off)
    got = emulate_top2(_placed(p, off), off, rows, m)
    _assert_same(got, jax_top2(jnp.asarray(p), row_blk=128))
