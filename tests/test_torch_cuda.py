"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one.  They import nothing
of JAX, so they also run where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.knn_projection import knn_actions       # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.knn_topk import ops, row_top2_regret_ref  # noqa: E402
from repro_torch.kernels.knn_topk.ref import edge_rows        # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops     # noqa: E402
from repro_torch.kernels.rwkv6_scan import wkv6_ref           # noqa: E402
from torch_lm_cases import BATCHER_SCENARIOS, frontend_inputs, smoke_lm  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in float32
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(800, 10), (25600, 10), (7, 3), (1, 2),
                                   (513, 16), (300, 33), (2, 16, 25, 10)])
def test_kernel_matches_plain_version(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    p = torch.rand(shape, generator=g, device=cuda_device)
    p[..., :3, :] = torch.round(p[..., :3, :] * 2) / 2       # tied rows
    before = ops.LAUNCHES
    got = ops.row_top2_regret(p)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = row_top2_regret_ref(p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float((got[2] - want[2]).abs().max()) <= 1e-6


@pytest.mark.parametrize("shape", [(128, 16), (8, 16, 16), (8, 32, 16, 16)])
def test_kernel_at_the_placement_shapes(cuda_device, shape):
    """The expert-placement env's DDPG: 16 experts on 16 devices, so rows
    of m = 16: the select's [F·16, 16] at F = 8 (flat and as the beam's
    [F, E, D]) and an update's [F, B, E, D]; one launch each, on the
    kernel and never on the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(16)
    p = torch.rand(shape, generator=g, device=cuda_device)
    p.view(-1, 16)[::9] = torch.round(p.view(-1, 16)[::9] * 2) / 2   # ties
    before = ops.LAUNCHES
    got = ops.row_top2_regret(p)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    _assert_as_plain(got, row_top2_regret_ref(p))


def test_ddpg_on_placement_on_the_card_equals_the_cpu(cuda_device):
    """DDPG on the full-size placement env (E = D = 16), F = 2, T = 4 under
    a mixed fleet: the same moves on the card as on the CPU, every select
    and update through the K-NN kernel."""
    from repro_torch.core import convert, jamba_placement_env, make_agent
    from repro_torch.core import run_online_fleet
    from repro_torch.dsdps import scenarios

    F, T = 2, 4
    rng = np.random.default_rng(3)
    cpu_env = jamba_placement_env(device="cpu")
    skew = torch.as_tensor(rng.normal(size=(F, 16)).astype(np.float32))
    init = convert.ddpg_state_to_numpy(make_agent("ddpg", cpu_env, k_nn=8).init_fleet(
        torch.Generator().manual_seed(0), F, "cpu"))
    draws = [d._replace(meas_z=d.meas_z[:, 0]) for d in _epoch_draws(
        rng, F, 16, 16, 16, 32, T)]
    hists = []
    for dev in ("cpu", cuda_device):
        env = jamba_placement_env(device=dev)
        before = ops.LAUNCHES
        hists.append(run_online_fleet(
            0, env, make_agent("ddpg", env, k_nn=8),
            convert.ddpg_state_from_numpy(init, dev), T,
            env_params=scenarios.build_for(env, "mixed", F, skew_z=skew.to(dev)),
            draws=[d.to(dev) for d in draws])[1])
    assert ops.LAUNCHES == before + 2 * T
    np.testing.assert_array_equal(hists[1].moved, hists[0].moved)
    np.testing.assert_array_equal(hists[1].final_assignment,
                                  hists[0].final_assignment)
    np.testing.assert_allclose(hists[1].latencies, hists[0].latencies, rtol=1e-5)


def test_kernel_skips_the_launch_for_no_rows(cuda_device):
    before = ops.LAUNCHES
    best, second, regret = ops.row_top2_regret(
        torch.empty(0, 10, device=cuda_device))
    assert best.shape == second.shape == regret.shape == (0,)
    assert ops.LAUNCHES == before


def _assert_as_plain(got, want):
    """Indices exact; regret within 1e-6, NaN and ±inf at the same places."""
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("m", range(2, 34))
def test_kernel_matches_plain_version_on_edge_rows(cuda_device, m):
    """NaN, ±inf, all -inf, below and tied with -1e30, -0.0, ties: each
    edge row once among 300 uniform rows, so that they share tiles."""
    names, rows = edge_rows(m)
    g = torch.Generator(device=cuda_device).manual_seed(m)
    p = torch.rand(300, m, generator=g, device=cuda_device)
    p[::16][:len(names)] = rows.to(cuda_device)
    got = ops.row_top2_regret(p)
    torch.cuda.synchronize()
    _assert_as_plain(got, row_top2_regret_ref(p))


@pytest.mark.parametrize("m", [2, 3, 4, 8, 10, 16, 17, 33])
@pytest.mark.parametrize("rows", [1, 129, 25600])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_kernel_reads_views_off_the_16_byte_grid(cuda_device, m, rows, offset):
    g = torch.Generator(device=cuda_device).manual_seed(rows * m + offset)
    flat = torch.rand(offset + rows * m, generator=g, device=cuda_device)
    flat[offset::7] = torch.round(flat[offset::7] * 2) / 2          # ties
    p = flat[offset:].view(rows, m)
    assert p.is_contiguous() and p.data_ptr() % 16 == 4 * offset
    got = ops.row_top2_regret(p)
    torch.cuda.synchronize()
    _assert_as_plain(got, row_top2_regret_ref(p))


@pytest.mark.parametrize("shape", [(10,), (800, 10), (2, 16, 25, 10),
                                   (5, 33)])
def test_kernel_outputs_and_one_launch_per_call(cuda_device, shape):
    p = torch.rand(shape, device=cuda_device)
    before = ops.LAUNCHES
    best, second, regret = ops.row_top2_regret(p)
    assert ops.LAUNCHES == before + 1
    for t, dtype in ((best, torch.int32), (second, torch.int32),
                     (regret, torch.float32)):
        assert t.dtype == dtype and t.shape == shape[:-1]
        assert t.is_contiguous() and t.device == p.device


@pytest.mark.parametrize("shape,k,quant", [((8, 100, 10), 16, None),
                                           ((8, 32, 100, 10), 16, None),
                                           ((2, 20, 10), 12, 4)])
def test_beam_on_the_card_equals_the_beam_on_the_cpu(cuda_device, shape, k,
                                                     quant):
    p = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    if quant:
        p = np.round(p * quant) / quant
    gpu = knn_actions(torch.as_tensor(p, device=cuda_device), k).cpu()
    assert torch.equal(gpu, knn_actions(torch.as_tensor(p), k))


# -- flash attention: tests/test_kernels.py's cases, a ragged S, every head
# dim the kernels take, strided views, and a llama3-8b head layout.
# (rtol, atol) of |got - want| <= atol + rtol |want|.  float32: both sides
# compute in float32.  bfloat16: both round a float32 result to bfloat16
# (one step is at most 2^-7 of |want|), and the kernel carries P into P.V
# as two bfloat16 parts; tests/test_torch_flash_numerics.py emulates that
# arithmetic on the CPU at these cases and tolerances
FLASH_TOLS = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 2e-3)}
FLASH_CASES = [
    (2, 128, 4, 4, 64, True, torch.float32),
    (2, 128, 4, 2, 64, True, torch.float32),
    (2, 256, 8, 2, 32, True, torch.float32),
    (2, 128, 4, 1, 64, True, torch.float32),
    (2, 128, 4, 2, 64, False, torch.float32),
    (2, 128, 4, 2, 64, True, torch.bfloat16),
    (2, 200, 4, 2, 32, True, torch.float32),      # ragged S
    (2, 200, 4, 2, 32, False, torch.bfloat16),
    (3, 37, 4, 2, 16, True, torch.float32),       # hd 16, S below one tile
    (1, 1, 4, 2, 128, True, torch.float32),       # one row
    (1, 512, 32, 8, 128, True, torch.bfloat16),   # llama3-8b heads
    # the bfloat16 route (wgmma + TMA) at every head dim, both maskings,
    # ragged S, one row
    (2, 128, 4, 2, 16, True, torch.bfloat16),
    (2, 128, 4, 2, 16, False, torch.bfloat16),
    (2, 256, 8, 2, 32, True, torch.bfloat16),
    (2, 256, 8, 2, 32, False, torch.bfloat16),
    (2, 128, 4, 4, 64, False, torch.bfloat16),
    (2, 384, 4, 1, 128, False, torch.bfloat16),
    (2, 200, 4, 2, 64, True, torch.bfloat16),     # ragged S
    (2, 200, 4, 2, 128, False, torch.bfloat16),
    (3, 37, 4, 2, 16, True, torch.bfloat16),      # S below one tile
    (3, 37, 4, 2, 128, False, torch.bfloat16),
    (1, 1, 4, 2, 128, True, torch.bfloat16),      # one row
    (1, 1, 4, 2, 16, False, torch.bfloat16),
    # hd 96 on both routes (phi-3-vision's 3072/32), and hd 8 and 40, which
    # the wrapper zero-pads to 16 and 64
    (2, 256, 8, 2, 96, True, torch.float32),
    (2, 200, 4, 2, 96, False, torch.float32),
    (2, 200, 4, 2, 8, True, torch.float32),
    (2, 128, 4, 1, 40, False, torch.float32),
    (2, 256, 8, 2, 96, True, torch.bfloat16),
    (2, 200, 4, 1, 96, False, torch.bfloat16),
    (3, 37, 4, 2, 96, True, torch.bfloat16),
    (2, 200, 4, 2, 8, True, torch.bfloat16),
    (2, 128, 4, 2, 40, False, torch.bfloat16),
    (1, 1, 4, 2, 40, True, torch.bfloat16),
    # hd 192 and 256 native on the CUDA-core kernel (float32, and bf16
    # above the tensor-core kernel's 128); hd 160 zero-padded to 192
    (2, 200, 4, 2, 160, True, torch.float32),
    (2, 128, 4, 1, 192, False, torch.float32),
    (2, 256, 8, 2, 256, True, torch.float32),
    (3, 37, 4, 2, 256, False, torch.float32),
    (2, 200, 4, 2, 160, False, torch.bfloat16),
    (2, 256, 4, 1, 192, True, torch.bfloat16),
    (2, 200, 8, 2, 256, True, torch.bfloat16),
    (3, 37, 4, 2, 256, False, torch.bfloat16),
]


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain_version(cuda_device, B, S, H, Hkv, hd,
                                            causal, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(S + hd)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=cuda_device).to(dtype)
               for h in (H, Hkv, Hkv))
    before = fa_ops.LAUNCHES
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal)
    rtol, atol = FLASH_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_kernel_reads_strided_views(cuda_device):
    """q, k, v as slices of one fused projection [B, S, H + 2 Hkv, hd]."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, 96, 8, 32, generator=g, device=cuda_device)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa_ops.flash_attention(q, k, v)
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_flash_bf16_kernel_reads_strided_views(cuda_device):
    """The bfloat16 route's TMA maps take a fused [B, S, H + 2 Hkv, hd]
    projection's slices as they are."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn(2, 160, 8, 64, generator=g, device=cuda_device).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    before = fa_ops.LAUNCHES_BF16
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES_BF16 == before + 1
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    rtol, atol = FLASH_TOLS[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_bf16_wrapper_stages_what_tma_cannot_load(cuda_device):
    """TMA is never handed a layout it cannot load: a base 2 bytes past
    alignment, or an h stride of 20 elements (40 bytes), is copied into a
    fresh contiguous allocation, and the bf16 kernel runs on the copy."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    flat = torch.randn(1 + 2 * 64 * 4 * 64, generator=g,
                       device=cuda_device).bfloat16()
    shifted = flat[1:].view(2, 64, 4, 64)             # base 2 bytes past alignment
    ok = torch.randn(2, 64, 4, 64, generator=g, device=cuda_device).bfloat16()
    wide = torch.randn(2, 64, 4, 20, generator=g, device=cuda_device).bfloat16()
    rtol, atol = FLASH_TOLS[torch.bfloat16]
    for q, k, v, staged in ((ok, shifted, ok, 1),
                            (ok[..., :16], ok[..., :16], wide[..., :16], 1),
                            (shifted[..., :16], shifted[..., :16], wide[..., 4:], 3)):
        before = (fa_ops.LAUNCHES_BF16, fa_ops.STAGED_COPIES)
        got = fa_ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert (fa_ops.LAUNCHES_BF16, fa_ops.STAGED_COPIES) == (
            before[0] + 1, before[1] + staged)
        want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_routes_count_their_own_launches(cuda_device):
    q = torch.randn(1, 64, 2, 32, device=cuda_device)
    counts = (fa_ops.LAUNCHES, fa_ops.LAUNCHES_F32, fa_ops.LAUNCHES_BF16)
    fa_ops.flash_attention(q, q, q)
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_F32, fa_ops.LAUNCHES_BF16) == (
        counts[0] + 1, counts[1] + 1, counts[2])
    fa_ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    fa_ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    torch.cuda.synchronize()
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_F32, fa_ops.LAUNCHES_BF16) == (
        counts[0] + 3, counts[1] + 1, counts[2] + 2)


def test_flash_wrapper_runs_hd_264_on_the_wide_form(cuda_device):
    """The kernel lacks no head_dim: up to 256 every one runs (padded where
    not native), and above 256, where the wrapper once refused, hd 264 runs
    as it is on the wide form, one launch, nothing padded."""
    g = torch.Generator(device=cuda_device).manual_seed(264)
    q = torch.randn(1, 8, 2, 264, generator=g, device=cuda_device)
    before = (fa_ops.LAUNCHES, fa_ops.LAUNCHES_WIDE, fa_ops.LAUNCHES_PADDED)
    got = fa_ops.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_WIDE, fa_ops.LAUNCHES_PADDED) == (
        before[0] + 1, before[1] + 1, before[2])
    torch.testing.assert_close(got, flash_attention_ref(q, q, q), atol=2e-5,
                               rtol=2e-5)


# above 256 the CUDA-core kernel's wide form: column slices of 256, scores
# over chunks of 64 columns; both dtypes, both maskings, ragged S, S below
# one tile, one row, GQA and MQA
FLASH_WIDE_CASES = [
    (2, 256, 4, 2, 320, True, torch.float32),
    (2, 200, 4, 1, 320, False, torch.float32),
    (2, 256, 4, 2, 512, False, torch.float32),
    (3, 37, 4, 2, 512, True, torch.float32),
    (1, 1, 2, 1, 300, True, torch.float32),
    (1, 130, 2, 2, 257, True, torch.float32),
    (2, 256, 4, 2, 320, False, torch.bfloat16),
    (2, 200, 4, 1, 320, True, torch.bfloat16),
    (2, 256, 4, 2, 512, True, torch.bfloat16),
    (3, 37, 4, 2, 512, False, torch.bfloat16),
    (1, 64, 2, 1, 1000, True, torch.bfloat16),
]


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,dtype", FLASH_WIDE_CASES)
def test_flash_wide_head_dims_match_plain_version(cuda_device, B, S, H, Hkv, hd,
                                                  causal, dtype):
    """hd above 256 in either dtype: one launch of the wide form (counted
    on its own; bf16 through the bf16 entry point onto the CUDA cores),
    nothing padded or staged, the plain version's answer."""
    g = torch.Generator(device=cuda_device).manual_seed(S + hd)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=cuda_device).to(dtype)
               for h in (H, Hkv, Hkv))
    before = (fa_ops.LAUNCHES, fa_ops.LAUNCHES_WIDE, fa_ops.LAUNCHES_PADDED,
              fa_ops.STAGED_COPIES, fa_ops.LAUNCHES_BF16_CUDA_CORES)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_WIDE, fa_ops.LAUNCHES_PADDED,
            fa_ops.STAGED_COPIES, fa_ops.LAUNCHES_BF16_CUDA_CORES) == (
        before[0] + 1, before[1] + 1, before[2], before[3],
        before[4] + (dtype == torch.bfloat16))
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    want = flash_attention_ref(q, k, v, causal=causal)
    rtol, atol = FLASH_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_wide_form_reads_strided_views(cuda_device):
    """q, k, v as slices of one fused bf16 projection at hd 320."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn(2, 96, 8, 320, generator=g, device=cuda_device).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa_ops.flash_attention(q, k, v)
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    rtol, atol = FLASH_TOLS[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# non-causal attention at a key length of its own (cross-attention over an
# encoder's memory): a memory longer and shorter than q, ragged on both,
# one key, on the bf16 wgmma route, the float32 route, bf16 above 128 on
# the CUDA cores, a padded hd, and the wide form in both dtypes
FLASH_CROSS_CASES = [
    (2, 64, 256, 4, 4, 64, torch.bfloat16),      # seamless's head layout
    (2, 200, 37, 4, 2, 128, torch.bfloat16),
    (1, 37, 300, 4, 2, 96, torch.bfloat16),
    (2, 128, 1, 4, 2, 16, torch.bfloat16),
    (2, 130, 129, 4, 1, 32, torch.bfloat16),
    (2, 64, 256, 4, 4, 64, torch.float32),
    (2, 200, 37, 4, 2, 128, torch.float32),
    (1, 37, 300, 4, 2, 96, torch.float32),
    (2, 128, 1, 4, 2, 16, torch.float32),
    (2, 100, 70, 4, 2, 192, torch.bfloat16),
    (2, 64, 200, 4, 2, 40, torch.bfloat16),
    (2, 100, 70, 4, 2, 320, torch.float32),
    (1, 37, 130, 2, 1, 512, torch.bfloat16),
]


@pytest.mark.parametrize("B,S,Skv,H,Hkv,hd,dtype", FLASH_CROSS_CASES)
def test_flash_kernel_takes_a_key_length_of_its_own(cuda_device, B, S, Skv, H, Hkv,
                                                    hd, dtype):
    """q ``[B, S, H, hd]`` against k, v ``[B, Skv, Hkv, hd]``, non-causal:
    one launch, counted at its shape, the plain version's answer."""
    g = torch.Generator(device=cuda_device).manual_seed(S + Skv + hd)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(B, Skv, Hkv, hd, generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    before = (fa_ops.LAUNCHES, fa_ops.LAUNCHES_WIDE)
    fa_ops.LAUNCHES_BY_SHAPE.clear()
    got = fa_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_WIDE) == (before[0] + 1,
                                                       before[1] + (hd > 256))
    assert fa_ops.LAUNCHES_BY_SHAPE == {
        f"{S}x{Skv} full {str(dtype).removeprefix('torch.')}": 1}
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=False)
    rtol, atol = FLASH_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_kernel_refuses_causal_attention_at_another_key_length(cuda_device):
    q = torch.randn(1, 64, 4, 64, device=cuda_device).bfloat16()
    k = torch.randn(1, 128, 4, 64, device=cuda_device).bfloat16()
    before = fa_ops.LAUNCHES
    with pytest.raises(ValueError, match="causal attention needs"):
        fa_ops.flash_attention(q, k, k, causal=True)
    assert fa_ops.LAUNCHES == before


@pytest.mark.parametrize("hd", [136, 192, 256])
def test_flash_bf16_above_128_runs_on_the_cuda_cores(cuda_device, hd):
    """A bf16 head dim above 128 takes the CUDA-core kernel's bf16
    instantiation through the bf16 entry point (counted on its own), reads
    strided views as they lie (nothing staged), and equals the plain
    version; hd 128 stays on the tensor-core route."""
    g = torch.Generator(device=cuda_device).manual_seed(hd)
    qkv = torch.randn(2, 96, 8, hd, generator=g, device=cuda_device).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    before = (fa_ops.LAUNCHES_BF16, fa_ops.LAUNCHES_BF16_CUDA_CORES,
              fa_ops.STAGED_COPIES)
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (fa_ops.LAUNCHES_BF16, fa_ops.LAUNCHES_BF16_CUDA_CORES,
            fa_ops.STAGED_COPIES) == (before[0] + 1, before[1] + 1, before[2])
    rtol, atol = FLASH_TOLS[torch.bfloat16]
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    small = torch.randn(1, 64, 2, 128, generator=g, device=cuda_device).bfloat16()
    cores = fa_ops.LAUNCHES_BF16_CUDA_CORES
    fa_ops.flash_attention(small, small, small)
    assert fa_ops.LAUNCHES_BF16_CUDA_CORES == cores


@pytest.mark.parametrize("hd,native", [(1, 16), (8, 16), (40, 64), (48, 64),
                                       (80, 96), (96, 96), (100, 128),
                                       (136, 192), (200, 256), (256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_pads_head_dims_between_native_ones(cuda_device, hd, native, dtype):
    """One launch a call; a head_dim that is not native is zero-padded to
    the next one (counted), scaled by 1/sqrt of the true head_dim, and
    sliced back to a contiguous [B, S, H, hd]."""
    g = torch.Generator(device=cuda_device).manual_seed(hd)
    q, k, v = (torch.randn(2, 130, h, hd, generator=g, device=cuda_device).to(dtype)
               for h in (4, 2, 2))
    before = (fa_ops.LAUNCHES, fa_ops.LAUNCHES_PADDED, fa_ops.STAGED_COPIES)
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (fa_ops.LAUNCHES, fa_ops.LAUNCHES_PADDED, fa_ops.STAGED_COPIES) == (
        before[0] + 1, before[1] + (hd != native), before[2])
    assert got.shape == q.shape and got.is_contiguous() and got.dtype == dtype
    rtol, atol = FLASH_TOLS[dtype]
    torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v).float(),
                               atol=atol, rtol=rtol)


# -- wkv6: tests/test_kernels.py's cases, a carried state, one step, bf16,
# the rwkv6-7b head size and heads (its decode and batcher steps), and a T
# one past a chunk (32 steps at
# hd <= 64, 16 at hd = 128)
WKV_CASES = [
    (2, 64, 2, 16, torch.float32, False),
    (2, 128, 3, 16, torch.float32, False),
    (2, 96, 2, 8, torch.float32, False),
    (2, 64, 2, 16, torch.bfloat16, False),
    (2, 75, 3, 32, torch.float32, True),
    (4, 1, 64, 64, torch.bfloat16, True),          # rwkv6-7b decode step
    (8, 1, 64, 64, torch.bfloat16, True),          # the batcher's step, 8 slots
    (2, 300, 4, 64, torch.float32, True),
    (1, 40, 2, 128, torch.float32, True),
    (1, 2048, 4, 64, torch.bfloat16, False),       # rwkv6-7b prefill length
    (2, 33, 2, 64, torch.float32, True),           # T = C + 1
    (1, 17, 2, 128, torch.bfloat16, False),        # T = C + 1 at hd 128
]


def _wkv_inputs(device, B, T, H, hd, dtype, carry):
    g = torch.Generator(device=device).manual_seed(T + hd)
    shape = (B, T, H, hd)
    w = torch.sigmoid(torch.randn(shape, generator=g, device=device)) * 0.5 + 0.45
    r, k, v = (torch.randn(shape, generator=g, device=device).to(dtype)
               for _ in range(3))
    u = torch.randn(H, hd, generator=g, device=device) * 0.5
    S0 = torch.randn(B, H, hd, hd, generator=g, device=device) if carry else None
    return w, r, k, v, u, S0


def _check_wkv(args):
    before = wkv_ops.LAUNCHES
    out, S_T = wkv_ops.wkv6(*args)
    torch.cuda.synchronize()
    assert wkv_ops.LAUNCHES == before + 1
    want, want_S = wkv6_ref(*(a if a is None else a.contiguous() for a in args))
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(S_T, want_S, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,T,H,hd,dtype,carry", WKV_CASES)
def test_wkv6_kernel_matches_plain_version(cuda_device, B, T, H, hd, dtype,
                                           carry):
    _check_wkv(_wkv_inputs(cuda_device, B, T, H, hd, dtype, carry))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_reads_strided_views(cuda_device, dtype):
    """w, r, k, v as h- and t-strided slices of larger tensors, the last
    axis contiguous; r starts one element past a 16-byte boundary, so it
    is staged in narrower copies than the others."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, T, H, hd = 2, 70, 3, 64

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    # decays in (0.45, 0.95), the h-slice of a wider tensor
    w = (torch.sigmoid(randn(B, T, 2 * H, hd, dt=torch.float32)) * 0.5 + 0.45)[:, :, H:]
    rkv = randn(B, T, 3 * H, hd)                       # a fused r/k/v projection
    flat = randn(1 + B * 2 * T * H * hd)
    r = flat[1:].view(B, 2 * T, H, hd)[:, ::2]         # t-strided, base + 1 element
    k, v = rkv[:, :, H:2 * H], rkv[:, :, 2 * H:]
    assert r.data_ptr() % 16 != 0 and r.stride(1) == 2 * H * hd
    u = randn(H, hd, dt=torch.float32) * 0.5
    S0 = randn(B, H, hd, hd, dt=torch.float32)
    _check_wkv((w, r, k, v, u, S0))


# -- the baselines on the card: one epoch of each under a lane-stacked
# scenario equals the same epoch on the CPU, from the same state (made on
# the CPU and carried across) and the same draws
def _epoch_draws(rng, F, N, M, S, B, T=1):
    from repro_torch.core import EpochDraws
    return [EpochDraws(
        explore_add=torch.as_tensor(rng.uniform(size=F) < 0.6),
        explore_noise=torch.as_tensor(rng.uniform(size=(F, N, M)).astype(np.float32)),
        explore_move=torch.as_tensor(rng.integers(0, N * M, F)),
        meas_z=torch.as_tensor(rng.normal(size=(F, 5)).astype(np.float32)),
        rate_z=torch.as_tensor(rng.normal(size=(F, S)).astype(np.float32)),
        replay_idx=torch.as_tensor(rng.integers(0, 1, (F, 1, B))),
        explore_gumbel=torch.as_tensor(rng.gumbel(size=(F, N, M)).astype(np.float32)))
        for _ in range(T)]


@pytest.mark.parametrize("name", ["dqn", "round_robin", "model_based"])
def test_baseline_epoch_on_the_card_equals_the_cpu(cuda_device, name):
    from repro_torch.core import make_agent, run_online_fleet
    from repro_torch.core.convert import dqn_state_from_numpy, dqn_state_to_numpy
    from repro_torch.dsdps import EnvParams, SchedulingEnv, apps, scenarios

    topo = apps.continuous_queries("small")
    F = 3
    cpu_env = SchedulingEnv(topo, apps.default_workload(topo), device="cpu")
    params = scenarios.build("mixed", cpu_env, F, broadcast_invariant=True)
    agent = make_agent(name, cpu_env, **({"fit_samples": 60}
                                         if name == "model_based" else {}))
    init = agent.init_fleet(torch.Generator().manual_seed(0), F, "cpu",
                            env_params=params)
    if name == "dqn":
        init = dqn_state_to_numpy(init)
    draws = _epoch_draws(np.random.default_rng(0), F, cpu_env.N, cpu_env.M,
                         cpu_env.workload.num_spouts,
                         getattr(agent.cfg, "batch", 1))
    hists = []
    for dev in ("cpu", cuda_device):
        env = SchedulingEnv(topo, apps.default_workload(topo), device=dev)
        ag = make_agent(name, env, **({"fit_samples": 60}
                                      if name == "model_based" else {}))
        states = (dqn_state_from_numpy(init, dev) if name == "dqn"
                  else init.clone().to(dev))
        _, h = run_online_fleet(0, env, ag, states, 1,
                                env_params=EnvParams(*(x.to(dev) for x in params)),
                                draws=[d.to(dev) for d in draws])
        hists.append(h)
    np.testing.assert_array_equal(hists[1].moved, hists[0].moved)
    np.testing.assert_array_equal(hists[1].final_assignment,
                                  hists[0].final_assignment)
    np.testing.assert_allclose(hists[1].latencies, hists[0].latencies, rtol=1e-5)


def test_model_based_select_at_cq_large_within_memory(cuda_device):
    """One select of 8 model-based lanes at cq_large (N·M = 1000 moves a
    lane) peaks at two [8, 1000, 100, 100] float32 temporaries (640 MB)
    and the [8, 1000, 100, 10] candidates (32 MB): held under 1 GiB.  The
    move it takes is the model's best on the CPU too, to float32
    tolerance (cq_large has moves the model ties exactly in theory)."""
    from repro_torch.core import make_agent
    from repro_torch.core import model_based as mb
    from repro_torch.dsdps import EnvParams, SchedulingEnv, apps, scenarios

    topo = apps.continuous_queries("large")
    env = SchedulingEnv(topo, apps.default_workload(topo), device=cuda_device)
    F = 8
    params = scenarios.build("one_slow_machine", env, F, broadcast_invariant=True)
    agent = make_agent("model_based", env, fit_samples=400)
    thetas = agent.init_fleet(torch.Generator(device=cuda_device).manual_seed(0),
                              F, cuda_device, env_params=params)
    state = env.reset(F, params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    X, _ = agent.select_fn(agent.cfg, thetas, None, state, params, True, None,
                           None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= 2 ** 30, f"select peaked at {peak / 2**20:.1f} MiB"
    assert torch.equal(X.sum(-1), torch.ones(F, env.N, device=cuda_device))
    assert ((X != state.X).any(-1).sum(-1) <= 1).all()
    # the CPU's predictions of every candidate: the card's move is a best
    cpu_env = SchedulingEnv(topo, apps.default_workload(topo), device="cpu")
    cpu_params = EnvParams(*(x.cpu() for x in params))
    cand = mb._candidate_moves(state.X.cpu())
    preds = mb.predict_latency(cpu_env, thetas.cpu(), cand, state.w.cpu()[:, None],
                               cpu_params)
    chosen = (cand == X.cpu()[:, None]).flatten(2).all(-1)
    got = torch.where(chosen, preds, torch.inf).amin(-1)
    torch.testing.assert_close(got, preds.amin(-1), rtol=1e-5, atol=0)


# -- the serving control plane on the card: the same weights, clusters and
# requests as on the CPU give the same decisions, and every placement step
# is one K-NN launch over all its slots
def test_serving_plane_on_the_card_equals_the_cpu(cuda_device):
    from repro_torch.launch import serve_control as sc
    from repro_torch.launch.drl_control import build_env

    out = {}
    for dev in ("cpu", cuda_device):
        env = build_env("cq_small", dev)
        svc = sc.build_service(env, n_slots=4, seed=0)
        sc.register_perturbed(svc, env, 5, seed=0)
        before = ops.LAUNCHES
        res = sc.serve(svc, sc.synthetic_requests(env, svc, 48, seed=0))
        torch.cuda.synchronize()
        out[str(dev)] = (res, ops.LAUNCHES - before, svc)
    (cpu, _, _), (card, launches, svc) = out["cpu"], out[str(cuda_device)]
    assert launches == svc.planes["placement"].steps == 4
    want = {r.rid: r.action for r in cpu["served"]}
    assert len(card["served"]) == 48
    for r in card["served"]:
        np.testing.assert_array_equal(r.action, want[r.rid])


# -- the streaming agents and the structural fleets on the card: the same
# states (made on the CPU and carried across), scenarios and draws as on
# the CPU give the same moves
def _streaming_run(name, env, params, init, draws, dev, T):
    from repro_torch.core import convert, make_agent, run_online_fleet
    load = {"stream_q": convert.stream_q_state_from_numpy,
            "stream_ac": convert.stream_ac_state_from_numpy,
            "graph_policy": convert.graph_policy_state_from_numpy}[name]
    p = type(params)(*(x.to(dev) for x in params))
    return run_online_fleet(0, env, make_agent(name, env), load(init, dev), T,
                            env_params=p, draws=[d.to(dev) for d in draws])[1]


@pytest.mark.parametrize("name", ["stream_q", "stream_ac", "graph_policy"])
def test_streaming_fleet_on_the_card_equals_the_cpu(cuda_device, name):
    from repro_torch.core import convert, make_agent
    from repro_torch.dsdps import SchedulingEnv, apps, scenarios

    topo = apps.continuous_queries("small")
    F, T = 2, 5
    cpu_env = SchedulingEnv(topo, apps.default_workload(topo), device="cpu")
    params = scenarios.build("mixed", cpu_env, F, broadcast_invariant=True)
    dump = {"stream_q": convert.stream_q_state_to_numpy,
            "stream_ac": convert.stream_ac_state_to_numpy,
            "graph_policy": convert.graph_policy_state_to_numpy}[name]
    init = dump(make_agent(name, cpu_env).init_fleet(
        torch.Generator().manual_seed(0), F, "cpu"))
    draws = _epoch_draws(np.random.default_rng(1), F, cpu_env.N, cpu_env.M,
                         cpu_env.workload.num_spouts, 1, T)
    hists = [_streaming_run(name, SchedulingEnv(topo, apps.default_workload(topo),
                                                device=dev),
                            params, init, draws, dev, T)
             for dev in ("cpu", cuda_device)]
    np.testing.assert_array_equal(hists[1].moved, hists[0].moved)
    np.testing.assert_array_equal(hists[1].final_assignment,
                                  hists[0].final_assignment)
    np.testing.assert_allclose(hists[1].latencies, hists[0].latencies, rtol=1e-5)


def test_structural_graph_policy_on_the_card_equals_the_cpu(cuda_device):
    from repro_torch.core import convert, make_agent
    from repro_torch.dsdps import StructuralSchedulingEnv, apps, scenarios

    F, T = 3, 5
    cpu_env = StructuralSchedulingEnv(apps.structural_topologies(), device="cpu")
    params = scenarios.build("dag_shapes", cpu_env, F)
    init = convert.graph_policy_state_to_numpy(make_agent(
        "graph_policy", cpu_env).init_fleet(torch.Generator().manual_seed(0), F,
                                            "cpu"))
    draws = _epoch_draws(np.random.default_rng(2), F, cpu_env.N, cpu_env.M,
                         cpu_env.envelope.max_spouts, 1, T)
    hists = [_streaming_run("graph_policy", StructuralSchedulingEnv(
        apps.structural_topologies(), device=dev), params, init, draws, dev, T)
        for dev in ("cpu", cuda_device)]
    np.testing.assert_array_equal(hists[1].moved, hists[0].moved)
    np.testing.assert_array_equal(hists[1].final_assignment,
                                  hists[0].final_assignment)
    np.testing.assert_allclose(hists[1].latencies, hists[0].latencies, rtol=1e-5)
    # each padded topology's round-robin score equals its plain env's
    from repro_torch.dsdps import SchedulingEnv
    card = StructuralSchedulingEnv(apps.structural_topologies(), device=cuda_device)
    for t in card.topologies:
        plain = SchedulingEnv(t, apps.default_workload(t), device=cuda_device)
        p = card.params_for(t)
        got = card.evaluate(card.round_robin_assignment(), p.base_rates, params=p)
        want = plain.evaluate(plain.round_robin_assignment(),
                              plain.default_params().base_rates)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)



def _card_ddpg_bundle(device, F=2):
    """A DDPG fleet's checkpoint bundle at cq_small: agent states, env
    state and generator, on ``device``."""
    from repro_torch.core import make_agent
    from repro_torch.dsdps import SchedulingEnv, apps

    topo = apps.continuous_queries("small")
    env = SchedulingEnv(topo, apps.default_workload(topo), device=device)
    states = make_agent("ddpg", env, k_nn=4).init_fleet(
        torch.Generator(device=device).manual_seed(0), F, device)
    return {"agent": states, "env": env.reset(F),
            "gen": torch.Generator(device=device).manual_seed(5)}


def _leaf_values(bundle):
    from repro_torch.checkpoint import named_leaves

    return [(n, x.get_state() if isinstance(x, torch.Generator) else x.detach().cpu().clone())
            for n, x in named_leaves(bundle)]


@pytest.mark.parametrize("overlap_transfer", [True, False])
def test_async_save_of_card_tensors_survives_in_place_writes(cuda_device, tmp_path,
                                                             overlap_transfer):
    """save_async snapshots the CUDA leaves on the current stream before it
    returns: kernels that write every leaf in place right after it, and a
    draw from the CUDA generator, while the writer is slowed, leave the
    file with the values of the call (bit for bit)."""
    import time

    from repro_torch.checkpoint import AsyncCheckpointer, named_leaves

    ck = AsyncCheckpointer(tmp_path, overlap_transfer=overlap_transfer)
    orig_write = ck._write

    def slow_write(*a, **k):
        time.sleep(0.2)
        return orig_write(*a, **k)

    ck._write = slow_write
    bundle = _card_ddpg_bundle(cuda_device)
    want = _leaf_values(bundle)
    for step in (1, 2, 3):           # the third reuses the first's pinned buffers
        ck.save_async(step, bundle)
        with torch.no_grad():
            for _, leaf in named_leaves(bundle):
                if isinstance(leaf, torch.Generator):
                    torch.rand(1024, generator=leaf, device=cuda_device)
                else:
                    leaf.add_(step)
    ck.close()
    got = _leaf_values(ck.restore(_card_ddpg_bundle(cuda_device), step=1))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), name


def test_card_checkpoint_restores_into_a_cpu_template(cuda_device, tmp_path):
    """A DDPG fleet run on the card for 4 epochs, saved every 2: its
    checkpoint restores into CPU agent and env templates bit for bit (the
    generator into a CUDA generator: a CPU one raises)."""
    from repro_torch.checkpoint import FleetCheckpoint, named_leaves
    from repro_torch.core import make_agent, run_online_fleet
    from repro_torch.dsdps import SchedulingEnv, apps

    topo = apps.continuous_queries("small")
    card = SchedulingEnv(topo, apps.default_workload(topo), device=cuda_device)
    agent = make_agent("ddpg", card, k_nn=4)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ck = FleetCheckpoint(tmp_path, every=2)
    states, hist = run_online_fleet(gen, card, agent, agent.init_fleet(
        torch.Generator(device=cuda_device).manual_seed(0), 2, cuda_device), 4,
        checkpoint=ck)
    ck.close()
    cpu = SchedulingEnv(topo, apps.default_workload(topo), device="cpu")
    cpu_agent = make_agent("ddpg", cpu, k_nn=4)
    template = cpu_agent.init_fleet(torch.Generator().manual_seed(7), 2, "cpu")
    with pytest.raises(ValueError, match="same device type"):
        ck.restore(template, cpu.reset(2), torch.Generator())
    epoch, r_states, r_env, r_gen = ck.restore(
        template, cpu.reset(2), torch.Generator(device=cuda_device))
    assert epoch == 4
    for (name, a), (_, b) in zip(named_leaves(r_states), named_leaves(states)):
        assert a.device.type == "cpu" and torch.equal(a, b.cpu()), name
    np.testing.assert_array_equal(r_env.X.numpy(), hist.final_assignment)
    assert torch.equal(r_gen.get_state(), gen.get_state())


def test_cuda_generator_state_roundtrip(cuda_device, tmp_path):
    """A CUDA generator's state (seed and Philox offset) saves and restores:
    the restored generator repeats the draws that followed the save."""
    from repro_torch.checkpoint import Checkpointer

    ck = Checkpointer(tmp_path)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    torch.rand(1000, generator=g, device=cuda_device)
    ck.save(1, {"gen": g})
    want = torch.rand(1000, generator=g, device=cuda_device)
    r = ck.restore({"gen": torch.Generator(device=cuda_device)})["gen"]
    assert torch.equal(torch.rand(1000, generator=r, device=cuda_device), want)


# --------------------------------------------------------------------------
# the runtime guards and the elastic lifecycle on the card
# --------------------------------------------------------------------------
def _syncing_round_robin(env):
    """Round-robin whose tick waits on the device once an epoch."""
    from repro_torch.core import make_agent

    rr = make_agent("round_robin", env)
    return rr._replace(tick_fn=lambda cfg, s: s + int(s.sum().item() * 0) + 1)


def test_guard_disallow_raises_in_the_steady_state_not_at_the_boundary(cuda_device):
    from repro_torch.core import run_online_fleet
    from repro_torch.diagnostics import guards, lifted, steady
    from repro_torch.dsdps import SchedulingEnv, apps

    x = torch.ones(3, device=cuda_device)
    with guards(transfer="disallow"):
        with pytest.raises(RuntimeError, match="synchroniz"):
            x.sum().item()                          # the region is armed
        with lifted():
            assert x.sum().item() == 3.0            # boundary work
            with steady():
                with pytest.raises(RuntimeError, match="synchroniz"):
                    x.sum().item()
            assert x.sum().item() == 3.0
    assert torch.cuda.get_sync_debug_mode() == 0
    topo = apps.continuous_queries("small")
    env = SchedulingEnv(topo, apps.default_workload(topo), device=cuda_device)
    agent = _syncing_round_robin(env)
    with guards(transfer="disallow"), pytest.raises(RuntimeError, match="synchroniz"):
        run_online_fleet(0, env, agent, agent.init_fleet(None, 2, cuda_device), 3)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_guard_log_counts_the_steady_states_syncs_by_site(cuda_device):
    """Under "log" the tick's wait counts once an epoch at its line; the
    stop test's ``.item()`` at the chunk boundary does not count."""
    import numpy as np

    from repro_torch.diagnostics import guards
    from repro_torch.dsdps import SchedulingEnv, apps
    from repro_torch.fleet import StopRule, run_online_fleet_elastic

    topo = apps.continuous_queries("small")
    env = SchedulingEnv(topo, apps.default_workload(topo), device=cuda_device)
    agent = _syncing_round_robin(env)
    probe = torch.ones(1, device=cuda_device)

    def stop_fn(rewards, t):
        probe.item()                                 # boundary: lifted
        return np.zeros(rewards.shape[0], bool)

    with guards(transfer="log") as g:
        res = run_online_fleet_elastic(0, env, agent, agent.init_fleet(None, 2, cuda_device),
                                       6, rule=StopRule(check_every=2), stop_fn=stop_fn)
    assert res.executed_lane_epochs == 12 and g.steady_steps == 6
    tick = _syncing_round_robin.__code__.co_firstlineno + 5
    assert g.syncs[f"test_torch_cuda.py:{tick}"] == 6, g.sync_report()
    assert not [s for s in g.syncs if s.startswith("test_torch_cuda.py:") and
                not s.endswith(f":{tick}")], g.sync_report()
    assert torch.cuda.get_sync_debug_mode() == 0


def test_elastic_run_on_the_card_equals_the_cpu(cuda_device):
    """DDPG at cq_small, F=3, T=8, lane 1 stopped at 4, on the same numpy
    draws: moves and lane accounting exact, traces at 1e-4."""
    import numpy as np

    from repro_torch.core import EpochDraws, convert, make_agent
    from repro_torch.dsdps import SchedulingEnv, apps
    from repro_torch.fleet import StopRule, run_online_fleet_elastic

    F, T = 3, 8
    topo = apps.continuous_queries("small")
    rng = np.random.default_rng(22)
    out = {}
    init = None
    for where in ("cpu", cuda_device):
        env = SchedulingEnv(topo, apps.default_workload(topo), device=where)
        agent = make_agent("ddpg", env, k_nn=4, batch=8)
        if init is None:
            init = convert.ddpg_state_to_numpy(
                agent.init_fleet(torch.Generator().manual_seed(22), F, "cpu"))
            draws = [EpochDraws(
                explore_add=torch.as_tensor(rng.uniform(size=F) < 0.6),
                explore_noise=torch.as_tensor(rng.uniform(size=(F, env.N, env.M))
                                              .astype(np.float32)),
                explore_move=torch.as_tensor(rng.integers(0, env.N * env.M, F)),
                meas_z=torch.as_tensor(rng.normal(size=(F, 5)).astype(np.float32)),
                rate_z=torch.as_tensor(rng.normal(size=(F, env.workload.num_spouts))
                                       .astype(np.float32)),
                replay_idx=torch.as_tensor(rng.integers(0, t + 1, (F, 1, 8))),
                explore_gumbel=torch.zeros(F, env.N, env.M)) for t in range(T)]

        def stop(rewards, t):
            return np.arange(rewards.shape[0]) == 1 if t == 4 else np.zeros(
                rewards.shape[0], bool)
        out[str(where)] = run_online_fleet_elastic(
            0, env, agent, convert.ddpg_state_from_numpy(init, where), T,
            rule=StopRule(check_every=4), draws=[d.to(where) for d in draws],
            stop_fn=stop)
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert card.epochs_run.tolist() == cpu.epochs_run.tolist() == [T, 4, T]
    assert card.executed_lane_epochs == cpu.executed_lane_epochs
    np.testing.assert_array_equal(card.history.moved, cpu.history.moved)
    np.testing.assert_array_equal(card.history.final_assignment,
                                  cpu.history.final_assignment)
    np.testing.assert_allclose(card.history.latencies, cpu.history.latencies, rtol=1e-4)


# --------------------------------------------------------------------------
# LM serving beyond llama3-8b, the MoE dispatch and the continuous batcher
# on the card, against the CPU on the same float32 weights
# --------------------------------------------------------------------------
def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("arch", ["yi-34b", "command-r-plus-104b", "qwen1.5-110b",
                                  "granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_lm_config_on_the_card_equals_the_cpu(cuda_device, arch):
    from repro_torch.models import lm
    from repro_torch.serve import Engine

    cfg, cpu = smoke_lm(arch, 24)
    toks = torch.randint(1, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    got = {}
    for where, params in (("cpu", cpu), ("card", _to(cpu, cuda_device))):
        d = "cpu" if where == "cpu" else cuda_device
        logits, _ = lm.prefill_forward(cfg)(params, {"tokens": toks.to(d)})
        out = Engine(cfg, params, max_seq=40, batch_size=2, device=d).generate(None, toks, 12)
        got[where] = logits.cpu(), out.cpu()
    assert float((got["card"][0] - got["cpu"][0]).abs().max()) <= 1e-4
    assert torch.equal(got["card"][1], got["cpu"][1])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_moe_dispatch_on_the_card_equals_the_cpu(cuda_device, arch):
    """Expert ids, slots and keep exact, the output within 1e-5 in float32
    (a capacity factor that drops tokens); in bf16 two card runs give the
    same bits."""
    from repro_torch.configs import get_config
    from repro_torch.models import ffn

    cfg = get_config(arch, smoke=True)
    p = ffn.moe_init(torch.Generator().manual_seed(3), cfg.d_model, cfg.d_ff,
                     cfg.num_experts, cfg.num_shared_experts, dtype=torch.float32,
                     device="cpu")
    x = torch.randn(3, 40, cfg.d_model, generator=torch.Generator().manual_seed(4))
    kw = dict(experts_per_token=cfg.experts_per_token, capacity_factor=0.75)
    card_p = _to(p, cuda_device)
    want = ffn.moe_route(p, x, **kw)
    got = ffn.moe_route(card_p, x.to(cuda_device), **kw)
    assert int((~want.keep).sum()) > 0
    for name in ("expert", "slot", "keep"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    out, aux = ffn.moe_ffn(card_p, x.to(cuda_device), **kw)
    out_cpu, aux_cpu = ffn.moe_ffn(p, x, **kw)
    assert float((out.cpu() - out_cpu).abs().max()) <= 1e-5
    assert abs(float(aux) - float(aux_cpu)) <= 1e-6
    p16 = _to(ffn.moe_init(torch.Generator().manual_seed(3), cfg.d_model, cfg.d_ff,
                           cfg.num_experts, cfg.num_shared_experts, device="cpu"),
              cuda_device)
    x16 = x.to(cuda_device).bfloat16()
    a, _ = ffn.moe_ffn(p16, x16, **kw)
    b, _ = ffn.moe_ffn(p16, x16, **kw)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("scenario", sorted(BATCHER_SCENARIOS))
def test_batcher_on_the_card_equals_the_cpu(cuda_device, arch, scenario):
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    from repro_torch.serve import ContinuousBatcher, Request

    cfg, cpu = smoke_lm(arch, 24)
    n_slots, max_seq, reqs = BATCHER_SCENARIOS[scenario]
    got = {}
    for where, params in (("cpu", cpu), ("card", _to(cpu, cuda_device))):
        cb = ContinuousBatcher(cfg, params, max_seq=max_seq, n_slots=n_slots,
                               eos_id=-1, device="cpu" if where == "cpu" else cuda_device)
        for rid, (prompt, new) in enumerate(reqs):
            cb.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=new))
        before = wkv.LAUNCHES
        got[where] = [(r.rid, r.out) for r in cb.run(None)]
        steps = cb.cache["len"]
    assert got["card"] == got["cpu"]
    # one WKV launch a layer a step on the card (none on the CPU)
    assert wkv.LAUNCHES - before == (cfg.num_layers * steps if cfg.family == "ssm" else 0)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "phi-3-vision-4.2b",
                                  "seamless-m4t-medium"])
def test_last_three_families_on_the_card_equal_the_cpu(cuda_device, arch):
    """The float32 smoke configs of the hybrid, vlm and encdec families:
    prefill_forward logits within 1e-4 (with the vlm's patch embeddings,
    and seamless's 48 frames against a 20-token prompt, so its
    cross-attention runs the kernel at Skv = 48), greedy tokens of
    Engine.generate (seamless with the same frames) identical."""
    from repro_torch.models import lm
    from repro_torch.serve import Engine

    cfg, cpu = smoke_lm(arch, 25)
    toks = torch.randint(1, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    more = {k: torch.from_numpy(v) for k, v in frontend_inputs(cfg, 2, 25, 48).items()}
    got = {}
    for where, params in (("cpu", cpu), ("card", _to(cpu, cuda_device))):
        d = "cpu" if where == "cpu" else cuda_device
        before = fa_ops.LAUNCHES
        logits, _ = lm.prefill_forward(cfg)(params, {"tokens": toks.to(d),
                                                     **{k: v.to(d) for k, v in more.items()}})
        launches = fa_ops.LAUNCHES - before
        eng = Engine(cfg, params, max_seq=40, batch_size=2, device=d, enc_len=48)
        out = eng.generate(None, toks, 12, frames=more.get("frames"))
        got[where] = logits.cpu(), out.cpu(), launches
    assert float((got["card"][0] - got["cpu"][0]).abs().max()) <= 1e-4
    assert torch.equal(got["card"][1], got["cpu"][1])
    attn_layers = sum(m == "attn" for m, _ in cfg.block_program()) * cfg.num_blocks
    # seamless: its encoder layers and its decoder's cross-attention too
    want = attn_layers + (cfg.encoder_layers + cfg.num_layers if cfg.encoder_layers else 0)
    assert (got["cpu"][2], got["card"][2]) == (0, want)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "seamless-m4t-medium"])
@pytest.mark.parametrize("scenario", sorted(BATCHER_SCENARIOS))
def test_new_families_batcher_on_the_card_equals_the_cpu(cuda_device, arch, scenario):
    """jamba's Mamba slots (their inherited h and conv) and seamless without
    a memory, through the continuous batcher: outputs and finish order."""
    from repro_torch.serve import ContinuousBatcher, Request

    cfg, cpu = smoke_lm(arch, 24)
    n_slots, max_seq, reqs = BATCHER_SCENARIOS[scenario]
    got = {}
    for where, params in (("cpu", cpu), ("card", _to(cpu, cuda_device))):
        cb = ContinuousBatcher(cfg, params, max_seq=max_seq, n_slots=n_slots,
                               eos_id=-1, device="cpu" if where == "cpu" else cuda_device)
        for rid, (prompt, new) in enumerate(reqs):
            cb.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=new))
        got[where] = [(r.rid, r.out) for r in cb.run(None)]
    assert got["card"] == got["cpu"]


# --------------------------------------------------------------------------
# the single-run entry and the fault module
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(20, 10), (640, 10), (16, 16), (512, 16),
                                   (160, 10), (5120, 10)])
def test_kernel_at_the_single_run_shapes(cuda_device, shape):
    """A single run's select and update rows on cq_small ([20, 10], [640,
    10]) and on the placement env ([16, 16], [512, 16]), and the
    scenario-fleet example's at F = 8 ([160, 10], [5120, 10]): one launch,
    counted at its shape."""
    g = torch.Generator(device=cuda_device).manual_seed(27)
    p = torch.rand(shape, generator=g, device=cuda_device)
    p[::7] = torch.round(p[::7] * 2) / 2                    # tied rows
    before, by_shape = ops.LAUNCHES, ops.LAUNCHES_BY_SHAPE.get(shape, 0)
    got = ops.row_top2_regret(p)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert ops.LAUNCHES_BY_SHAPE[shape] == by_shape + 1
    _assert_as_plain(got, row_top2_regret_ref(p))


def test_run_online_agent_on_the_card_equals_the_cpu(cuda_device):
    """DDPG's single run on cq_small, T = 5, U = 2, from one state made on
    the CPU and the same draws: the same moves and final assignment, every
    select and update through the K-NN kernel at the single run's shapes."""
    from repro_torch.core import convert, make_agent, run_online_agent
    from repro_torch.dsdps import SchedulingEnv, apps

    T, U = 5, 2
    topo = apps.continuous_queries("small")
    cpu_env = SchedulingEnv(topo, apps.default_workload(topo), device="cpu")
    init = convert.ddpg_state_to_numpy(make_agent("ddpg", cpu_env, k_nn=8).init_fleet(
        torch.Generator().manual_seed(5), 1, "cpu"))
    draws = _epoch_draws(np.random.default_rng(5), 1, 20, 10, 2, 32, T)
    draws = [d._replace(replay_idx=d.replay_idx.expand(1, U, 32)) for d in draws]
    hists = []
    for dev in ("cpu", cuda_device):
        env = SchedulingEnv(topo, apps.default_workload(topo), device=dev)
        before = dict(ops.LAUNCHES_BY_SHAPE)
        hists.append(run_online_agent(
            0, env, make_agent("ddpg", env, k_nn=8),
            convert.ddpg_state_from_numpy(init, dev), T, updates_per_epoch=U,
            draws=[d.to(dev) for d in draws])[1])
    torch.cuda.synchronize()
    new = {s: n - before.get(s, 0) for s, n in ops.LAUNCHES_BY_SHAPE.items()
           if n != before.get(s, 0)}
    assert new == {(20, 10): T, (640, 10): U * T}
    np.testing.assert_array_equal(hists[1].moved, hists[0].moved)
    np.testing.assert_array_equal(hists[1].final_assignment,
                                  hists[0].final_assignment)
    np.testing.assert_allclose(hists[1].latencies, hists[0].latencies, rtol=1e-4)


def test_mitigate_with_drl_on_the_card_takes_the_host_route(cuda_device):
    """The straggler mitigation selects from the host's exact k-best set:
    no K-NN launch, and the CPU's re-assignment from the same state."""
    from repro_torch.core import convert, ddpg, jamba_placement_env
    from repro_torch.fault import StragglerDetector, mitigate_with_drl

    out, init = [], None
    for dev in ("cpu", cuda_device):
        env = jamba_placement_env(device=dev)
        cfg = ddpg.DDPGConfig(n_executors=16, n_machines=16,
                              state_dim=env.state_dim, k_nn=8)
        if init is None:
            init = convert.ddpg_state_to_numpy(ddpg.init_state(
                torch.Generator().manual_seed(2), cfg, 1, "cpu"))
        det = StragglerDetector(16)
        for _ in range(8):
            for d in range(16):
                det.observe(d, 2.2 if d == 5 else 1.0)
        before = ops.LAUNCHES
        out.append(mitigate_with_drl(det, env, convert.ddpg_state_from_numpy(
            init, dev), cfg).cpu())
        assert ops.LAUNCHES == before
    assert torch.equal(out[0], out[1])


# -- LM training: the kernels' Functions and a train step ---------------------
@pytest.mark.parametrize("dtype, S, Skv, causal", [
    (torch.bfloat16, 128, 128, True), (torch.bfloat16, 64, 96, False),
    (torch.float32, 128, 128, True), (torch.float32, 64, 96, False)])
def test_flash_function_gradients_on_the_card(cuda_device, dtype, S, Skv, causal):
    """``FlashAttentionFn`` on the card: one forward launch a forward, one
    backward launch (counted apart) in the backward, and gradients of q,
    k, v within the flash bound (bf16: 1e-2·|x| + 2e-3; float32: 1e-5) of
    plain autograd's of the plain version, nonzero."""
    g = torch.Generator(device=cuda_device).manual_seed(S + Skv)
    q = torch.randn(2, S, 4, 64, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(2, Skv, 2, 64, generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    go = torch.randn(2, S, 4, 64, generator=g, device=cuda_device).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa_ops.LAUNCHES
    bwd_before = fa_ops.LAUNCHES_BWD
    out = fa_ops.flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None and fa_ops.LAUNCHES == before + 1
    got = torch.autograd.grad(out, leaves, go)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1 and fa_ops.LAUNCHES_BWD == bwd_before + 1
    plain = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*plain, causal=causal), plain, go.float())
    for a, b in zip(got, want):
        assert a.dtype == dtype and float(a.abs().max()) > 0
        bound = (1e-2 * b.abs() + 2e-3) if dtype == torch.bfloat16 else 1e-5 * (1 + b.abs())
        assert bool(((a.float() - b).abs() <= bound).all())


# the flash backward (csrc/flash_attention_bwd.cu): the tensor-core route at
# every native head dim, a padded one, ragged S, k/v of their own length
# and GQA groups 1-4; the CUDA-core route in float32 and in bf16 above 128,
# the wide head dims among them
FLASH_BWD_CASES = [
    (2, 128, 128, 4, 2, 64, True, torch.bfloat16),
    (1, 512, 512, 32, 8, 128, True, torch.bfloat16),     # llama3-8b heads
    (2, 200, 200, 4, 2, 128, True, torch.bfloat16),      # ragged S
    (2, 200, 37, 4, 2, 128, False, torch.bfloat16),
    (1, 64, 256, 16, 16, 64, False, torch.bfloat16),     # seamless's cross layout
    (3, 37, 37, 4, 1, 16, True, torch.bfloat16),
    (2, 130, 129, 4, 1, 32, False, torch.bfloat16),
    (1, 256, 256, 8, 2, 96, True, torch.bfloat16),
    (2, 200, 200, 4, 2, 40, True, torch.bfloat16),       # zero-padded to 64
    (1, 1, 1, 4, 2, 128, True, torch.bfloat16),          # one row
    (2, 200, 200, 4, 2, 64, True, torch.float32),
    (2, 100, 70, 4, 2, 96, False, torch.float32),
    (3, 37, 37, 4, 4, 16, True, torch.float32),
    (1, 37, 130, 2, 1, 320, False, torch.float32),       # wide
    (2, 130, 130, 4, 2, 256, True, torch.bfloat16),      # bf16 on the CUDA cores
    (1, 70, 70, 2, 1, 512, True, torch.bfloat16),
]


@pytest.mark.parametrize("B,S,Skv,H,Hkv,hd,causal,dtype", FLASH_BWD_CASES)
def test_flash_backward_matches_plain_version(cuda_device, B, S, Skv, H, Hkv, hd, causal,
                                              dtype):
    """One backward launch a Function backward (on the tensor cores for bf16
    up to hd 128), gradients within the flash bound of the backward's plain
    version (``flash_attention_bwd_ref`` from the forward kernel's
    log-sum-exp; bf16 1e-2·|x| + 2e-3, float32 1e-5·(1 + max|x|)); the
    forward's log-sum-exp within 1e-5 of the plain forward's."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref

    g = torch.Generator(device=cuda_device).manual_seed(S + Skv + hd)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(B, Skv, Hkv, hd, generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    go = torch.randn(B, S, H, hd, generator=g, device=cuda_device).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, causal=causal)
    lse = out.grad_fn.saved_tensors[3]
    _, want_lse = flash_attention_ref(q, k, v, causal=causal, with_lse=True)
    assert float((lse - want_lse).abs().max()) <= 1e-5 * (1 + float(want_lse.abs().max()))
    before = (fa_ops.LAUNCHES_BWD, fa_ops.LAUNCHES_BWD_TC)
    got = torch.autograd.grad(out, leaves, go)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16 and hd <= 128
    assert (fa_ops.LAUNCHES_BWD, fa_ops.LAUNCHES_BWD_TC) == (before[0] + 1, before[1] + tc)
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), lse, go.float(), causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape and bool(torch.isfinite(a).all())
        err = (a.float() - b).abs()
        if dtype == torch.bfloat16:
            assert bool((err <= 1e-2 * b.abs() + 2e-3).all())
        else:
            assert float(err.max()) <= 1e-5 * (1 + float(b.abs().max()))


def test_flash_backward_reads_strided_views_and_stages_the_rest(cuda_device):
    """q, k, v as slices of one fused projection are read where they lie;
    a view cp.async cannot load (a base off the 16-byte grid) is copied
    first (``STAGED_COPIES``); both give the contiguous inputs' bits."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn(2, 130, 8, 64, generator=g, device=cuda_device).bfloat16()
    go = torch.randn(2, 130, 4, 64, generator=g, device=cuda_device).bfloat16()

    def grads(q, k, v, do):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fa_ops.flash_attention(*leaves), leaves, do)
    want = grads(*(t.contiguous() for t in (qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:])),
                 go)
    staged = fa_ops.STAGED_COPIES
    got = grads(qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:], go)
    assert fa_ops.STAGED_COPIES == staged
    shifted = torch.empty(1 + go.numel(), dtype=go.dtype, device=cuda_device)[1:].view(
        go.shape)
    shifted.copy_(go)
    got_shifted = grads(qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:], shifted)
    torch.cuda.synchronize()
    assert fa_ops.STAGED_COPIES == staged + 1
    for a, b, c in zip(got, got_shifted, want):
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_is_the_same_bits_run_after_run(cuda_device, dtype):
    """No atomics: two backwards of the same inputs give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn(2, 300, 8, 128, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(2, 300, 2, 128, generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    go = torch.randn_like(q)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        runs.append(torch.autograd.grad(fa_ops.flash_attention(*leaves), leaves, go))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_wkv_function_gradients_on_the_card(cuda_device):
    """``WKV6Fn`` on the card at [2, 32, 2, 64] float32 with a carried
    state: one launch a forward, none in the backward, and the gradients
    of w, r, k, v, u, S0 within 1e-5·(1 + max|x|) of plain autograd's."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    B, T, H, hd = 2, 32, 2, 64
    w = torch.rand(B, T, H, hd, generator=g, device=cuda_device) * 0.5 + 0.45
    r, k, v = (torch.randn(B, T, H, hd, generator=g, device=cuda_device) for _ in range(3))
    u = torch.randn(H, hd, generator=g, device=cuda_device)
    S0 = torch.randn(B, H, hd, hd, generator=g, device=cuda_device)
    go = torch.randn(B, T, H, hd, generator=g, device=cuda_device)
    gs = torch.randn(B, H, hd, hd, generator=g, device=cuda_device)
    leaves = [t.clone().requires_grad_() for t in (w, r, k, v, u, S0)]
    before = wkv_ops.LAUNCHES
    out, S_T = wkv_ops.wkv6(*leaves)
    got = torch.autograd.grad((out, S_T), leaves, (go, gs))
    torch.cuda.synchronize()
    assert wkv_ops.LAUNCHES == before + 1 and out.grad_fn is not None
    plain = [t.clone().requires_grad_() for t in (w, r, k, v, u, S0)]
    want = torch.autograd.grad(wkv6_ref(*plain), plain, (go, gs))
    for a, b in zip(got, want):
        assert float(a.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-5 * (1 + float(b.abs().max()))


@pytest.mark.parametrize("arch", ["llama3-8b", "seamless-m4t-medium"])
def test_train_step_on_the_card_equals_the_cpu_and_counts_its_launches(cuda_device, arch):
    """One float32 ``make_train_step`` step of a smoke config on the card
    against the CPU from the same state two steps in (``warm_train_state``)
    and batch (loss and gradient norm within 1e-4 relative, parameters
    within 1e-4 of each leaf's scale), and the flash launches of the step
    by shape: each attention layer's forward twice a microbatch (the
    forward, and the recompute of the rematerialized block in the
    backward), seamless's encoder layers and cross-attentions too."""
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import tree_leaves
    from torch_lm_cases import on_device, warm_train_state

    setup = trainer.TrainSetup(micro_batches=2, learning_rate=1e-4, warmup_steps=1,
                               total_steps=10)
    cfg, state, batch = warm_train_state(arch, setup, 2, seed=3)
    step = trainer.make_train_step(cfg, setup)
    out = {}
    for where, d in (("cpu", "cpu"), ("card", cuda_device)):
        fa_ops.LAUNCHES_BY_SHAPE.clear()
        new, m = step(on_device(state, d), on_device(batch, d))
        torch.cuda.synchronize()
        out[where] = new, m, dict(fa_ops.LAUNCHES_BY_SHAPE)
    (cs, cm, cl), (gs, gm, gl) = out["cpu"], out["card"]
    assert cl == {}
    for key in ("loss", "grad_norm"):
        assert float(gm[key]) == pytest.approx(float(cm[key]), rel=1e-4)
    for a, b in zip(tree_leaves(gs.params), tree_leaves(cs.params)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-9
    n = 2 * setup.micro_batches
    want = {"16x16 causal float32": cfg.num_layers * n}
    if cfg.encoder_layers:
        want["16x16 full float32"] = (cfg.encoder_layers + cfg.num_layers) * n
    assert gl == want


def test_knn_regret_gradient_on_the_card(cuda_device):
    """``RowTop2RegretFn`` on the card: one launch, the indices and regret
    the kernel's, the regret's gradient plain autograd's of the plain
    version; the direct route (no grad) is still one launch."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    proto = torch.rand(8, 32, 10, generator=g, device=cuda_device)
    go = torch.randn(8, 32, generator=g, device=cuda_device)
    leaf = proto.clone().requires_grad_()
    before = ops.LAUNCHES
    best, second, regret = ops.row_top2_regret(leaf)
    (got,) = torch.autograd.grad(regret, leaf, go)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1 and regret.grad_fn is not None
    plain = proto.clone().requires_grad_()
    pb, ps, pr = row_top2_regret_ref(plain)
    (want,) = torch.autograd.grad(pr, plain, go)
    assert torch.equal(best, pb) and torch.equal(second, ps)
    assert float((regret.detach() - pr.detach()).abs().max()) <= 1e-6
    assert torch.equal(got, want)
    ops.row_top2_regret(proto)
    assert ops.LAUNCHES == before + 2


def test_two_slot_mesh_on_one_card_matches_unmeshed(cuda_device, monkeypatch):
    """cq_small, F=4, T=5, DDPG: a 2-slot mesh on the card
    (``REPRO_FLEET_SLOTS=2``) equals the unmeshed run on the same draws,
    bit for bit, and every block's select and update launch the K-NN
    kernel at the block's rows: [2·20, 10] and [2·32·20, 10]."""
    from repro_torch.core import make_agent, run_online_fleet
    from repro_torch.dsdps import SchedulingEnv, apps
    from repro_torch.dsdps.apps import default_workload
    from repro_torch.launch.mesh import SLOTS_ENV, make_fleet_mesh
    from test_torch_parity import numpy_epoch_draws

    F, T = 4, 5
    topo = apps.continuous_queries("small")
    env = SchedulingEnv(topo, default_workload(topo), device=cuda_device)
    agent = make_agent("ddpg", env, k_nn=8)
    draws = [d.to(cuda_device) for d in numpy_epoch_draws(
        np.random.default_rng(29), F, T, 1, agent.cfg.batch, env.N, env.M,
        env.workload.num_spouts)]

    def fresh():
        return agent.init_fleet(torch.Generator(device=cuda_device).manual_seed(0),
                                F, cuda_device)
    _, plain = run_online_fleet(0, env, agent, fresh(), T, draws=draws)
    monkeypatch.setenv(SLOTS_ENV, "2")
    mesh = make_fleet_mesh(device=cuda_device)
    ops.LAUNCHES_BY_SHAPE.clear()
    _, meshed = run_online_fleet(0, env, agent, fresh(), T, draws=draws, mesh=mesh)
    torch.cuda.synchronize()
    for f in ("rewards", "latencies", "moved", "final_assignment"):
        np.testing.assert_array_equal(getattr(meshed, f), getattr(plain, f))
    B = agent.cfg.batch
    assert dict(ops.LAUNCHES_BY_SHAPE) == {(2 * env.N, env.M): 2 * T,
                                          (2 * B * env.N, env.M): 2 * T}


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-GPU refusal")
def test_fleet_mesh_on_cuda_raises_without_a_gpu():
    from repro_torch.launch.mesh import make_fleet_mesh, make_host_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fleet_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()


@pytest.mark.parametrize("compress", [False, True])
def test_meshed_train_step_on_a_nccl_world_of_one(cuda_device, compress):
    """``make_production_mesh`` over a world of one on NCCL: a float32 smoke
    llama3-8b step with its state sharded by the policy equals the
    unmeshed step on the card bit for bit (loss, gradient norm, every leaf
    of the parameters, moments and EF residuals), under PyTorch's
    deterministic algorithms, with the unmeshed step's flash launches."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import tree_leaves
    from torch_lm_cases import on_device, warm_train_state

    setup = trainer.TrainSetup(micro_batches=2, learning_rate=1e-3, warmup_steps=1,
                               total_steps=10, compress_grads=compress)
    cfg, state, batch = warm_train_state("llama3-8b", setup, 2, seed=5)
    state, batch = on_device(state, cuda_device), on_device(batch, cuda_device)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    mesh = make_production_mesh()
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        fa_ops.LAUNCHES_BY_SHAPE.clear()
        want, wm = trainer.make_train_step(cfg, setup)(state, batch)
        plain_launches = dict(fa_ops.LAUNCHES_BY_SHAPE)
        fa_ops.LAUNCHES_BY_SHAPE.clear()
        sharded = trainer.shard_train_state(state, ShardingPolicy(mesh, cfg))
        got, gm = trainer.make_train_step(cfg, setup, mesh)(sharded, batch)
        torch.cuda.synchronize()
        assert dict(fa_ops.LAUNCHES_BY_SHAPE) == plain_launches != {}
        for key in ("loss", "grad_norm"):
            assert float(gm[key]) == float(wm[key])
        got = trainer.unshard_train_state(got)
        for tree in ("params", "ef_residual"):
            for a, b in zip(tree_leaves(getattr(got, tree)), tree_leaves(getattr(want, tree))):
                assert torch.equal(a, b), tree
        for a, b in zip(tree_leaves(got.opt.mu) + tree_leaves(got.opt.nu),
                        tree_leaves(want.opt.mu) + tree_leaves(want.opt.nu)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(was)
