"""The port's K-NN projection and its row-reduction kernel's plain version
against the reference (core/knn_projection.py, kernels/knn_topk).  The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py, which needs no JAX."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import assert_exact, assert_f32, to_torch, torch

from repro.core.knn_projection import (knn_actions_jax,
                                       knn_assignments_exact as jax_exact)
from repro.kernels.knn_topk import row_top2_regret as jax_top2
from repro.kernels.knn_topk import row_top2_regret_ref as jax_top2_ref
from repro_torch.core.knn_projection import (distance_to, knn_actions,
                                             knn_actions_exact,
                                             knn_assignments_exact,
                                             nearest_assignment)
from repro_torch.kernels import _build
from repro_torch.kernels.knn_topk import ops, row_top2_regret_ref
from repro_torch.kernels.knn_topk.ref import edge_rows

REPO = pathlib.Path(__file__).resolve().parents[1]

# the test_knn_topk_vs_ref sweep of the reference: n 2-60, m 2-16
SWEEP = [(seed, int(n), int(m)) for seed, (n, m) in enumerate(
    zip(np.random.default_rng(0).integers(2, 61, 12),
        np.random.default_rng(1).integers(2, 17, 12)))] + [(99, 60, 16),
                                                            (98, 2, 2)]


def _proto(seed, shape, quant=None):
    p = np.random.default_rng(seed).uniform(size=shape).astype(np.float32)
    if quant:                      # coarse values: ties within rows
        p = (np.round(p * quant) / quant).astype(np.float32)
    return p


@pytest.mark.parametrize("seed,n,m", SWEEP)
@pytest.mark.parametrize("quant", [None, 3])
def test_plain_row_top2_matches_pallas_kernel_and_reference(seed, n, m, quant):
    p = _proto(seed, (n, m), quant)
    got = row_top2_regret_ref(to_torch(p))
    # the Pallas kernel in interpret mode, as tests/test_kernels.py runs it
    pallas = jax_top2(jnp.asarray(p), row_blk=16)
    ref = jax_top2_ref(jnp.asarray(p))
    for want in (pallas, ref):
        assert_exact(got[0], want[0])
        assert_exact(got[1], want[1])
        assert_f32(got[2], want[2], rtol=1e-6, atol=1e-6)
    assert got[0].dtype == got[1].dtype == torch.int32


EDGE_MS = (2, 3, 10, 16, 33)
EDGE_CASES = [(m, i, name) for m in EDGE_MS
              for i, name in enumerate(edge_rows(m)[0])]


def assert_regret(got, want):
    """Within 1e-6, with NaN and ±inf at the same places."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("m,i,name", EDGE_CASES,
                         ids=[f"{name}-m{m}" for m, _, name in EDGE_CASES])
def test_plain_row_top2_matches_pallas_kernel_and_reference_on_edge_rows(
        m, i, name):
    """NaN ranks first (the first NaN is the maximum), ties go to the first
    index, -0.0 ties 0.0, and the masked best column (-1e30) is second
    where nothing else is above it: jnp.argmax's order, kept by the Pallas
    kernel and the port.  The reference's ``lax.top_k`` path returns two
    distinct columns and orders -0.0 below 0.0, so it differs from the
    Pallas kernel on exactly those rows, and is held to it elsewhere."""
    p = edge_rows(m)[1][i:i + 1].numpy()
    got = row_top2_regret_ref(to_torch(p))
    pallas = jax_top2(jnp.asarray(p), row_blk=16)
    assert_exact(got[0], pallas[0])
    assert_exact(got[1], pallas[1])
    assert_regret(got[2], pallas[2])
    ref = jax_top2_ref(jnp.asarray(p))
    if int(pallas[1][0]) == int(pallas[0][0]):
        assert int(ref[1][0]) != int(ref[0][0])          # top_k: distinct
    elif name == "neg_zero_first":
        assert (int(ref[0][0]), int(ref[1][0])) == (1, 0)   # 0.0 above -0.0
    else:
        assert_exact(got[0], ref[0])
        assert_exact(got[1], ref[1])
        assert_regret(got[2], ref[2])


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    p = to_torch(_proto(0, (2, 5, 7)))
    before = ops.LAUNCHES
    got = ops.row_top2_regret(p)
    want = row_top2_regret_ref(p)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].shape == (2, 5)
    assert ops.LAUNCHES == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p = to_torch(_proto(0, (8, 6)))
    with pytest.raises(TypeError, match="float32"):
        ops.row_top2_regret(p.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.row_top2_regret(p.t())
    with pytest.raises(ValueError, match=">= 2 columns"):
        ops.row_top2_regret(p[:, :1].contiguous())


def test_kernel_library_is_named_by_a_hash_of_its_sources(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    path = _build.library_path("knn_topk")
    assert path.parent == REPO / "build" / "kernels" and path.suffix == ".so"
    assert path.name.startswith("knn_topk-")
    assert path == _build.library_path("knn_topk")
    assert [s.name for s in _build.sources("knn_topk")] == ["knn_topk.cu"]


def test_kernel_build_dir_outside_a_checkout_must_be_given(monkeypatch,
                                                           tmp_path):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setattr(_build, "_ROOT", tmp_path)       # no pyproject.toml
    with pytest.raises(RuntimeError, match="REPRO_TORCH_BUILD_DIR"):
        _build.library_path("knn_topk")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "k"))
    assert _build.library_path("knn_topk").parent == tmp_path / "k"


# the shapes of tests/test_knn_projection.py's pallas-vs-XLA beam test
BEAM_CASES = [(0, (40, 10, 8)), (1, (25, 6, 6)), (2, (7, 3, 4)),
              (3, (100, 10, 16))]


@pytest.mark.parametrize("seed,nmk", BEAM_CASES)
@pytest.mark.parametrize("quant", [None, 4, 2])
def test_beam_bit_identical_to_reference(seed, nmk, quant):
    n, m, k = nmk
    if quant is None:
        p = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n, m)))
    else:
        p = _proto(seed, (n, m), quant)
    got = knn_actions(to_torch(p), k)
    assert got.shape == (k, n, m)
    for use_pallas in (False, True):
        assert_exact(got, knn_actions_jax(jnp.asarray(p), k,
                                          use_pallas=use_pallas))


@pytest.mark.parametrize("k", [12, 16])
def test_beam_with_exploration_noise_bit_identical_to_reference(k):
    """Protos as the select path makes them: sigmoid outputs, some
    saturated to exactly 1.0, plus ε-noise in [0, 1)."""
    rng = np.random.default_rng(k)
    p = 1.0 / (1.0 + np.exp(-rng.normal(scale=12.0, size=(30, 10))))
    p = (p.astype(np.float32) + rng.uniform(size=(30, 10)).astype(np.float32)
         * (rng.uniform(size=(30, 1)) < 0.3))
    assert_exact(knn_actions(to_torch(p), k),
                 knn_actions_jax(jnp.asarray(p), k))


def test_batched_beam_equals_per_instance_loop():
    p = _proto(5, (2, 3, 12, 5), quant=None)
    p[1, 2] = np.round(p[1, 2] * 2) / 2          # one tied instance
    got = knn_actions(to_torch(p), 6)
    assert got.shape == (2, 3, 6, 12, 5)
    for i in range(2):
        for j in range(3):
            assert torch.equal(got[i, j], knn_actions(to_torch(p[i, j]), 6))
            assert_exact(got[i, j], knn_actions_jax(jnp.asarray(p[i, j]), 6))


def test_beam_repeats_the_last_candidate_when_k_exceeds_the_candidates():
    p = _proto(6, (3, 2))                    # C = 1 + 3 + 3 + 1 = 8 < k
    got = knn_actions(to_torch(p), 11)
    assert_exact(got, knn_actions_jax(jnp.asarray(p), 11))
    assert torch.equal(got[8], got[10])


@pytest.mark.parametrize("seed,n,m,k", [(0, 5, 4, 7), (1, 12, 10, 16),
                                        (2, 3, 2, 12), (3, 30, 6, 5)])
def test_exact_knn_equals_reference(seed, n, m, k):
    p = _proto(seed, (n, m))
    assert_exact(knn_assignments_exact(p, k), jax_exact(p, k))
    acts = knn_actions_exact(p, k)
    assert acts.shape == (k, n, m) and acts.dtype == np.float32


def test_nearest_assignment_and_distance():
    p = to_torch(np.asarray([[0.1, 0.9], [0.7, 0.3]], np.float32))
    a = nearest_assignment(p)
    assert_exact(a, [[0.0, 1.0], [1.0, 0.0]])
    assert float(distance_to(torch.zeros(3, 4), torch.eye(4)[:3])) == 3.0
