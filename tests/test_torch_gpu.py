"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips where no CUDA device
is present. The module imports torch, numpy and the port only, so it also
runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.core.encode import leaf_scalars
from repro_torch.core.fttq import FTTQConfig
from repro_torch.kernels.quantize_pack import quantize_pack, quantize_pack_plain
from repro_torch.kernels.ternary_matmul import ternary_matmul, ternary_matmul_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(5,), (33001,), (3, 2048, 2048), (16, 8192, 2048)])
def test_quantize_pack_matches_plain(cuda_device, shape):
    """Codes and tile counts exact, tile sums within rtol 1e-5."""
    x = torch.randn(shape, generator=torch.Generator(cuda_device).manual_seed(0),
                    device=cuda_device)
    scal, _ = leaf_scalars(x, FTTQConfig())
    before = quantize_pack.launches
    packed, moments = quantize_pack(x, scal)
    assert quantize_pack.launches == before + 1
    ref_packed, ref_moments = quantize_pack_plain(x, scal)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref_packed)
    assert torch.equal(moments[:, 1], ref_moments[:, 1])
    torch.testing.assert_close(moments[:, 0], ref_moments[:, 0], rtol=1e-5, atol=0)


def test_quantize_pack_unaligned_leaf(cuda_device):
    """A view that starts off a 16-byte boundary takes the scalar loads."""
    base = torch.randn(4097, device=cuda_device)
    x = base[1:]
    scal = torch.tensor([4.0, 0.2], device=cuda_device)
    packed, moments = quantize_pack(x, scal)
    ref_packed, ref_moments = quantize_pack_plain(x, scal)
    assert torch.equal(packed, ref_packed)
    torch.testing.assert_close(moments, ref_moments, rtol=1e-5, atol=0)


def _random_packed(k: int, n: int, gen: torch.Generator, device) -> torch.Tensor:
    c = torch.randint(0, 3, (k // 4, 4, n), generator=gen, device=device, dtype=torch.uint8)
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 2048, 8192), (4, 8192, 2048),
                                   (128, 2048, 2048), (128, 2048, 8192), (128, 8192, 2048),
                                   (5, 256, 131), (33, 64, 70), (17, 4, 1), (1, 8, 4)])
def test_ternary_matmul_matches_plain(cuda_device, m, k, n):
    """fp32 with TF32 off; rtol and atol 1e-4 cover the summation order."""
    gen = torch.Generator(cuda_device).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen, device=cuda_device)
    packed = _random_packed(k, n, gen, cuda_device)
    wq = torch.tensor(0.37, device=cuda_device)
    before = ternary_matmul.launches
    y = ternary_matmul(x, packed, wq)
    assert ternary_matmul.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ternary_matmul_plain(x, packed, wq), rtol=1e-4, atol=1e-4)


def test_ternary_matmul_rejects_what_it_cannot_take(cuda_device):
    x = torch.randn(4, 64, device=cuda_device)
    packed = torch.zeros(16, 8, dtype=torch.uint8, device=cuda_device)
    wq = torch.tensor(1.0, device=cuda_device)
    with pytest.raises(TypeError):
        ternary_matmul(x.to(torch.bfloat16), packed, wq)
    with pytest.raises(ValueError):
        ternary_matmul(x[:, :32], packed, wq)
    with pytest.raises(ValueError):
        ternary_matmul(x, packed.cpu(), wq)
