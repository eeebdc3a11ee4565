"""quantnet_torch's CUDA kernels on the card, against their plain versions.

Marked `cuda`: they need an NVIDIA card and nvcc, and skip without them (the
check happens in a fixture, so every worker collects the same tests). Run on
the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import pytest
import torch

from quantnet_torch.core.config import Flags
from quantnet_torch.models import convnet
from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm, fused_dynamic_gemm_plain
from quantnet_torch.ops.int8_matmul import int8_gemm, int8_gemm_plain
from quantnet_torch.quantize import dynamic

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "m,k,n", [(48, 200, 136), (7, 33, 5), (1, 16, 1), (300, 27, 64), (4096, 576, 64), (129, 2304, 256)]
)
def test_int8_gemm_exact(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    before = int8_gemm.launches
    got = int8_gemm(a, b)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1
    assert torch.equal(got, int8_gemm_plain(a, b))


@pytest.mark.parametrize("m,k,n", [(1024, 4096, 512), (1024, 512, 10), (7, 600, 10), (33, 100, 130)])
def test_fused_dynamic_gemm_matches_plain(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device=dev) * 1e-2
    b = torch.randn((n,), generator=g, device=dev)
    got = fused_dynamic_gemm(x, w, ws, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused_dynamic_gemm_plain(x, w, ws, b), rtol=1e-5, atol=1e-4)


def test_wrapper_rejects_non_contiguous(dev):
    a = torch.zeros((8, 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        int8_gemm(a[:, ::2], a[:, ::2].contiguous())


def test_model_goes_through_the_kernels(dev):
    params, state = convnet.init(torch.Generator().manual_seed(0), device=dev)
    q, qs = dynamic.quantize(params, state)
    x = torch.randn((16, 32, 32, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    int8_gemm.launches = fused_dynamic_gemm.launches = 0
    got, _ = convnet.apply(q, qs, x)
    assert (int8_gemm.launches, fused_dynamic_gemm.launches) == (6, 2)
    ref, _ = convnet.apply(q, qs, x, flags=Flags(plain=True))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 * ref.abs().max().item())
