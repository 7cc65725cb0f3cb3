"""The plain versions of the port's flash-attention and WKV6 kernels
against the reference's Pallas kernels (interpret mode, called as
tests/test_kernels.py calls them) and their oracles, plus the wrappers'
checks and the shared build helper.  The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import to_numpy, torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rwkv6_scan import wkv6 as jax_wkv6
from repro.kernels.rwkv6_scan import wkv6_ref as jax_wkv6_ref
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import wkv6_ref
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm

# tests/test_kernels.py's tolerances
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a CPU tensor of ``dtype``: the
    float32 numbers are rounded to bfloat16 once, by JAX, and carried
    across bit for bit."""
    j = jnp.asarray(a, JNP[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])
    return j, t


def _qkv(seed, B, S, H, Hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    return [_pair(rng.normal(size=shape).astype(np.float32), dtype)
            for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]


# -- flash attention -----------------------------------------------------------
@pytest.mark.parametrize("S,H,Hkv,hd,causal,dtype", [
    (128, 4, 4, 64, True, "float32"),      # MHA causal
    (128, 4, 2, 64, True, "float32"),      # GQA 2:1
    (256, 8, 2, 32, True, "float32"),      # GQA 4:1, longer
    (128, 4, 1, 64, True, "float32"),      # MQA
    (128, 4, 2, 64, False, "float32"),     # bidirectional (encoder)
    (128, 4, 2, 64, True, "bfloat16"),     # bf16 inputs
    # head dims the card pads (8 -> 16, 40 -> 64) or runs natively (96,
    # phi-3-vision's 3072/32): the function at the true head dim
    (128, 4, 2, 8, True, "float32"),
    (128, 4, 1, 40, False, "float32"),
    (128, 4, 2, 96, True, "float32"),
    (128, 4, 2, 40, True, "bfloat16"),
    (128, 4, 2, 96, False, "bfloat16"),
])
def test_flash_plain_version_matches_pallas_kernel_and_oracle(S, H, Hkv, hd,
                                                              causal, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(0, 2, S, H, Hkv, hd, dtype)
    got = fa_ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == TORCH[dtype] and got.shape == qt.shape
    got = to_numpy(got.float())
    pallas = jax_flash(qj, kj, vj, causal=causal, q_blk=64, kv_blk=64)
    oracle = attention_ref(qj, kj, vj, causal=causal)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=TOLS[dtype], rtol=TOLS[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_computes_every_row_of_a_ragged_sequence(causal):
    """S = 200 is no multiple of a 64-row block: the Pallas kernel would
    drop the tail, so the oracle alone is the reference here."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, 2, 200, 4, 2, 32, "float32")
    got = fa_ops.flash_attention(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(to_numpy(got),
                               np.asarray(attention_ref(qj, kj, vj, causal=causal)),
                               atol=TOLS["float32"], rtol=TOLS["float32"])


def test_models_flash_attention_matches_the_reference_jnp_twin():
    """models/attention.flash_attention, the call on the prefill path, on
    both sides (the reference's chunked online softmax at 64-row chunks)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 2, 256, 4, 2, 32, "float32")
    want = jattn.flash_attention(qj, kj, vj, causal=True, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(to_numpy(tattn.flash_attention(qt, kt, vt)),
                               np.asarray(want), atol=2e-5, rtol=2e-5)


def test_decode_attention_and_cache_update_match_the_reference():
    B, Smax, H, Hkv, hd, t = 2, 33, 4, 2, 16, 20
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, B, Smax, H, Hkv, hd, "float32")
    want = jattn.decode_attention(qj[:, -1:], kj, vj, jnp.asarray(t, jnp.int32))
    got = tattn.decode_attention(qt[:, -1:], kt, vt, t)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-5, rtol=2e-5)
    kn, vn = kj[:, :1] * 2, vj[:, :1] * 3
    jk, jv = jattn.update_kv_cache(kj, vj, kn, vn, jnp.asarray(t, jnp.int32))
    tk, tv = kt.clone(), vt.clone()
    out = tattn.update_kv_cache(tk, tv, torch.from_numpy(np.array(kn)),
                                torch.from_numpy(np.array(vn)), t)
    assert out[0] is tk and out[1] is tv          # in place
    np.testing.assert_array_equal(to_numpy(tk), np.asarray(jk))
    np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv))


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_ops.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError, match="one dtype"):
        fa_ops.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="does not fit"):
        fa_ops.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="rank 4"):
        fa_ops.flash_attention(q[0], k[0], k[0])
    # a meta tensor takes the card path's checks (the dry-run's route)
    qm = q.to("meta").transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(ValueError, match="head_dim axis contiguous"):
        fa_ops.flash_attention(qm, k.to("meta"), k.to("meta"))


def test_flash_cpu_path_runs_the_plain_version_and_counts_no_launch():
    (_, qt), (_, kt), (_, vt) = _qkv(4, 1, 16, 2, 1, 16, "float32")
    before = fa_ops.LAUNCHES, fa_ops.LAUNCHES_F32, fa_ops.LAUNCHES_BF16
    got = fa_ops.flash_attention(qt, kt, vt, causal=True)
    assert torch.equal(got, flash_attention_ref(qt, kt, vt, causal=True))
    got = fa_ops.flash_attention(qt.bfloat16(), kt.bfloat16(), vt.bfloat16())
    assert got.dtype == torch.bfloat16
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_F32, fa_ops.LAUNCHES_BF16) == before


def test_flash_wrapper_pads_head_dims_up_to_256_and_refuses_above():
    """On the card a head_dim between native ones is zero-padded to the
    next: 136 to 192 and 200 to 256 (above the bf16 tensor-core kernel's
    128, on the CUDA-core kernel); above 256, where the wrapper once
    refused, the rule keeps the head dim as it is, for the wide form.  The
    choice reads the head dim alone, so it runs here."""
    assert fa_ops.HEAD_DIMS[-3:] == (128, 192, 256)
    assert fa_ops._padded_head_dim(136) == 192
    assert fa_ops._padded_head_dim(200) == 256
    assert fa_ops._padded_head_dim(256) == 256
    assert fa_ops._padded_head_dim(100) == 128
    assert fa_ops._padded_head_dim(264) == 264
    assert fa_ops._padded_head_dim(512) == 512


@pytest.mark.parametrize("hd,causal,dtype", [(320, True, "float32"),
                                             (512, False, "float32"),
                                             (320, False, "bfloat16"),
                                             (512, True, "bfloat16")])
def test_flash_wide_head_dims_plain_route_matches_pallas_kernel(hd, causal,
                                                                dtype):
    """Above 256 the card runs the CUDA-core kernel's wide form; on CPU
    tensors the wrapper's plain route computes the same function at any
    head dim, held to the Pallas kernel (interpret mode) and its oracle, and
    counts no launch."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(5, 1, 128, 2, 1, hd, dtype)
    before = (fa_ops.LAUNCHES, fa_ops.LAUNCHES_WIDE)
    got = fa_ops.flash_attention(qt, kt, vt, causal=causal)
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_WIDE) == before
    assert got.dtype == TORCH[dtype] and got.shape == qt.shape
    got = to_numpy(got.float())
    pallas = jax_flash(qj, kj, vj, causal=causal, q_blk=64, kv_blk=64)
    oracle = attention_ref(qj, kj, vj, causal=causal)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=TOLS[dtype], rtol=TOLS[dtype])


def test_flash_routes_are_chosen_by_dtype_alone():
    assert fa_ops.ENTRY == {torch.float32: "flash_attention_fwd_f32",
                            torch.bfloat16: "flash_attention_fwd_bf16"}
    assert fa_ops.ENTRY_BWD == {torch.float32: "flash_attention_bwd_f32",
                                torch.bfloat16: "flash_attention_bwd_bf16"}
    assert set(fa_ops.SIGNATURES) == set(fa_ops.ENTRY.values()) | set(
        fa_ops.ENTRY_BWD.values())


def test_tma_layout_check_names_the_tensor_it_refuses():
    """What the bfloat16 route's TMA maps need: 16-byte-aligned bases and
    b, s, h strides that are multiples of 16 bytes.  The check reads
    pointers and strides only, so it runs here on CPU tensors."""
    ok = torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16)
    fused = torch.zeros(2, 64, 8, 64, dtype=torch.bfloat16)
    fa_ops._check_tma_layout(q=ok, k=fused[:, :, 4:6], v=fused[:, :, 6:])
    shifted = torch.zeros(1 + ok.numel(), dtype=torch.bfloat16)[1:].view(ok.shape)
    with pytest.raises(ValueError, match="k starts at an address"):
        fa_ops._check_tma_layout(q=ok, k=shifted)
    padded = torch.zeros(2, 64, 4, 20, dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="v has strides"):
        fa_ops._check_tma_layout(q=ok[..., :16], v=padded)


# -- wkv6 --------------------------------------------------------------------------
def _wkv_inputs(seed, B, T, H, hd, dtype):
    """tests/test_kernels.py's distributions: w in (0.45, 0.95), u ~ 0.1 N."""
    rng = np.random.default_rng(seed)
    w = 1 / (1 + np.exp(-rng.normal(size=(B, T, H, hd)))) * 0.5 + 0.45
    rkv = [rng.normal(size=(B, T, H, hd)) for _ in range(3)]
    u = rng.normal(size=(H, hd)) * 0.1
    w, *rkv = (_pair(a.astype(np.float32), dtype) for a in (w, *rkv))
    u = _pair(u.astype(np.float32), dtype)
    # the port's kernel takes w and u in float32: the same (rounded) values
    return w, rkv, u


@pytest.mark.parametrize("T,H,hd,chunk,dtype", [
    (64, 2, 16, 16, "float32"),
    (128, 3, 16, 32, "float32"),
    (96, 2, 8, 32, "float32"),       # T not a multiple of 64
    (64, 2, 16, 16, "bfloat16"),
])
def test_wkv6_plain_version_matches_pallas_kernel_and_oracle(T, H, hd, chunk,
                                                            dtype):
    (wj, wt), rkv, (uj, ut) = _wkv_inputs(0, 2, T, H, hd, dtype)
    (rj, rt), (kj, kt), (vj, vt) = rkv
    out, S_T = wkv_ops.wkv6(wt.float(), rt, kt, vt, ut.float())
    assert out.dtype == S_T.dtype == torch.float32
    assert out.shape == (2, T, H, hd) and S_T.shape == (2, H, hd, hd)
    pallas = jax_wkv6(wj, rj, kj, vj, uj, chunk=chunk)
    oracle, oracle_S = jax_wkv6_ref(wj, rj, kj, vj, uj)
    tol = TOLS[dtype] * 5                 # tests/test_kernels.py's wkv6 tolerance
    for want in (pallas, oracle):
        np.testing.assert_allclose(to_numpy(out), np.asarray(want), atol=tol, rtol=1e-2)
    np.testing.assert_allclose(to_numpy(S_T), np.asarray(oracle_S), atol=tol, rtol=1e-2)


def test_wkv6_plain_version_carries_a_nonzero_state():
    (wj, wt), rkv, (uj, ut) = _wkv_inputs(1, 2, 40, 3, 16, "float32")
    (rj, rt), (kj, kt), (vj, vt) = rkv
    S0 = np.random.default_rng(2).normal(size=(2, 3, 16, 16)).astype(np.float32)
    out, S_T = wkv_ops.wkv6(wt, rt, kt, vt, ut, torch.from_numpy(S0))
    want, want_S = jax_wkv6_ref(wj, rj, kj, vj, uj, S0=jnp.asarray(S0))
    np.testing.assert_allclose(to_numpy(out), np.asarray(want), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(to_numpy(S_T), np.asarray(want_S), atol=1e-4, rtol=1e-5)


def test_wkv6_single_step_with_carried_state_matches_ssm_wkv_chunk():
    """The decode step's call: T = 1 from the carried state, against the
    reference's ssm._wkv_chunk (which returns (S_T, out))."""
    (wj, wt), rkv, (uj, ut) = _wkv_inputs(3, 4, 1, 4, 16, "float32")
    (rj, rt), (kj, kt), (vj, vt) = rkv
    S0 = np.random.default_rng(4).normal(size=(4, 4, 16, 16)).astype(np.float32)
    want_S, want = jssm._wkv_chunk(jnp.asarray(S0), wj, rj, kj, vj, uj)
    got_S, got = tssm._wkv_chunk(torch.from_numpy(S0), wt, rt, kt, vt, ut)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_numpy(got_S), np.asarray(want_S), atol=1e-5, rtol=1e-5)


def test_wkv6_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 2, 8)
    u = torch.zeros(2, 8)
    with pytest.raises(TypeError, match="float32"):
        wkv_ops.wkv6(x.bfloat16(), x, x, x, u)
    with pytest.raises(TypeError, match="one dtype"):
        wkv_ops.wkv6(x, x.bfloat16(), x, x, u)
    with pytest.raises(ValueError, match="u is"):
        wkv_ops.wkv6(x, x, x, x, torch.zeros(3, 8))
    with pytest.raises(ValueError, match="S0 is"):
        wkv_ops.wkv6(x, x, x, x, u, torch.zeros(1, 2, 8, 4))
    with pytest.raises(ValueError, match="differ"):
        wkv_ops.wkv6(x, x[:, :2], x, x, u)
    # a meta tensor takes the card path's checks (the dry-run's route)
    m = x.to("meta")
    with pytest.raises(ValueError, match="head_dim axis contiguous"):
        wkv_ops.wkv6(m, m.transpose(1, 3).contiguous().transpose(1, 3), m, m,
                     u.to("meta"))


def test_wkv6_cpu_path_runs_the_plain_version_and_counts_no_launch():
    (_, wt), rkv, (_, ut) = _wkv_inputs(5, 1, 6, 2, 8, "float32")
    (_, rt), (_, kt), (_, vt) = rkv
    before = wkv_ops.LAUNCHES
    got = wkv_ops.wkv6(wt, rt, kt, vt, ut)
    want = wkv6_ref(wt, rt, kt, vt, ut)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert wkv_ops.LAUNCHES == before


# -- the shared build helper -----------------------------------------------------
@pytest.mark.parametrize("name,source,headers", [
    pytest.param("knn_topk", ["knn_topk.cu"], [], id="knn_topk-knn_topk.cu"),
    pytest.param("flash_attention", ["flash_attention.cu", "flash_attention_bwd.cu",
                                     "flash_attention_sm90.cu"],
                 ["sm90.cuh"], id="flash_attention-flash_attention.cu"),
    pytest.param("rwkv6_scan", ["wkv6.cu"], [], id="rwkv6_scan-wkv6.cu")])
def test_every_kernel_builds_from_its_own_sources_under_a_content_hash(
        monkeypatch, name, source, headers):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert [s.name for s in _build.sources(name)] == source
    assert [s.name for s in _build.build_inputs(name)] == sorted(source + headers)
    path = _build.library_path(name)
    assert path.name.startswith(f"{name}-") and path.suffix == ".so"
    assert path == _build.library_path(name)
    others = {_build.library_path(n) for n in ("knn_topk", "flash_attention",
                                               "rwkv6_scan")}
    assert len(others) == 3


def test_editing_a_header_changes_the_library_name(monkeypatch, tmp_path):
    """Headers are hashed with the sources, so an edited header builds anew
    instead of reusing a stale library; files the build never reads are
    not hashed, and headers are not compiled on their own."""
    import shutil
    kernels = tmp_path / "kernels"
    shutil.copytree(_build._KERNELS / "flash_attention" / "csrc",
                    kernels / "flash_attention" / "csrc")
    monkeypatch.setattr(_build, "_KERNELS", kernels)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    csrc = kernels / "flash_attention" / "csrc"
    before = _build.library_path("flash_attention")
    (csrc / "notes.txt").write_text("not read by the build\n")
    assert _build.library_path("flash_attention") == before
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = _build.library_path("flash_attention")
    assert after != before and after.parent == tmp_path / "build"
    assert all(s.suffix == ".cu" for s in _build.sources("flash_attention"))


def test_build_helper_raises_for_a_kernel_without_sources():
    with pytest.raises(FileNotFoundError, match="no CUDA sources"):
        _build.sources("no_such_kernel")


def test_package_data_covers_every_kernel_source():
    import fnmatch
    import pathlib
    import tomllib
    root = pathlib.Path(__file__).resolve().parents[1]
    cfg = tomllib.loads((root / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["repro_torch"]
    pkg = root / "src" / "repro_torch"
    for name in ("knn_topk", "flash_attention", "rwkv6_scan"):
        for src in _build.build_inputs(name):
            rel = src.relative_to(pkg).as_posix()
            assert any(fnmatch.fnmatch(rel, g.replace("**/", "*/")) for g in globs), rel


def test_jax_reference_kernels_run_here():
    """The Pallas kernels compared above really ran (interpret mode)."""
    assert jax.default_backend() == "cpu"
