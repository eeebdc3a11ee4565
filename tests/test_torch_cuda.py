"""quantnet_torch's CUDA kernels on the card, against their plain versions.

Marked `cuda`: they need an NVIDIA card and nvcc, and skip without them (the
check happens in a fixture, so every worker collects the same tests). Run on
the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import pytest
import torch

from quantnet_torch.core.config import Flags
from quantnet_torch.core.types import ActQuant
from quantnet_torch.models import convnet, resnet
from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm, fused_dynamic_gemm_plain
from quantnet_torch.ops.int8_matmul import int8_gemm, int8_gemm_plain
from quantnet_torch.ops.residual_boundary import residual_boundary, residual_boundary_plain
from quantnet_torch.quantize import dynamic, static

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1024, 4096, 512), (1024, 512, 10), (7, 600, 10), (33, 100, 130)])
def test_fused_dynamic_gemm_matches_plain(dev, m, k, n, dtype):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
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


# The JAX test shapes, odd shapes off the 16-element vector step, and
# ResNet-50's four boundary shapes at bs128.
BOUNDARY_SHAPES = [(2, 9, 9, 256), (4, 7, 7, 512), (1, 7, 9, 3), (3, 5, 5, 17),
                   (128, 56, 56, 256), (128, 28, 28, 512), (128, 14, 14, 1024), (128, 7, 7, 2048)]


@pytest.mark.parametrize("int8_id", [True, False])
@pytest.mark.parametrize("shape", BOUNDARY_SHAPES)
def test_residual_boundary_bit_exact(dev, shape, int8_id):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    out = torch.randn(shape, generator=g, device=dev) * 3.0
    if int8_id:
        ident = torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)
        id_q = ActQuant(torch.tensor(0.043, device=dev), torch.tensor(-5, dtype=torch.int32, device=dev))
    else:
        ident, id_q = torch.randn(shape, generator=g, device=dev), None
    out_q = ActQuant(torch.tensor(0.061, device=dev), torch.tensor(-100, dtype=torch.int32, device=dev))
    before = residual_boundary.launches
    got = residual_boundary(out, ident, id_q, out_q)
    torch.cuda.synchronize()
    assert residual_boundary.launches == before + 1
    assert torch.equal(got, residual_boundary_plain(out, ident, id_q, out_q))


def test_static_resnet18_goes_through_the_kernels(dev):
    params, state = resnet.init(torch.Generator().manual_seed(0), depth=18, device=dev)
    calib = torch.randn((4, 64, 64, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    q, qs = static.quantize(params, state, resnet.apply, [calib], skip_first_layer=True)
    x = torch.randn((4, 64, 64, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    int8_gemm.launches = residual_boundary.launches = 0
    got, _ = resnet.apply(q, qs, x)
    # 19 int8 convs (the stem stays fp32) + fc; 7 of 8 blocks hand int8 on.
    assert (int8_gemm.launches, residual_boundary.launches) == (20, 7)
    ref, _ = resnet.apply(q, qs, x, flags=Flags(plain=True))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 * ref.abs().max().item())


def test_fp32_conv_keeps_f32_and_restores_cudnn_flags(dev):
    """The fp32 conv (the stem under skip_first_layer) agrees with a float64
    conv to f32 order, which TF32 (about 1e-3 relative) would not, and leaves
    the caller's cuDNN settings as they were."""
    from quantnet_torch.ops.conv import conv2d

    g = torch.Generator().manual_seed(3)
    layer = {"w": torch.randn((7, 7, 3, 64), generator=g).to(dev)}
    x = torch.randn((2, 64, 64, 3), generator=g).to(dev)
    cudnn = torch.backends.cudnn
    before = (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic)
    got = conv2d(layer, x, stride=2, padding="SAME")
    assert (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic) == before
    # Computed in float64; conv2d hands the fp32 branch's result on as float32.
    ref = conv2d({"w": layer["w"].double()}, x.double(), stride=2, padding="SAME")
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())
