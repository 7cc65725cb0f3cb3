"""The port's CUDA kernel on the card, against its plain version.

These tests need an NVIDIA GPU and skip without one.  They import nothing
of JAX, so they also run where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.knn_projection import knn_actions       # noqa: E402
from repro_torch.kernels.knn_topk import ops, row_top2_regret_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
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


def test_kernel_skips_the_launch_for_no_rows(cuda_device):
    before = ops.LAUNCHES
    best, second, regret = ops.row_top2_regret(
        torch.empty(0, 10, device=cuda_device))
    assert best.shape == second.shape == regret.shape == (0,)
    assert ops.LAUNCHES == before


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
