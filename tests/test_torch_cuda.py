"""quantnet_torch's CUDA kernels on the card, against their plain versions.

Marked `cuda`: they need an NVIDIA card and nvcc, and skip without them (the
check happens in a fixture, so every worker collects the same tests). Run on
the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import pytest
import torch

from quantnet_torch.core.config import Flags
from quantnet_torch.core.quantize import quantize_affine
from quantnet_torch.core.types import ActQuant
from quantnet_torch.models import convnet, resnet
from quantnet_torch.ops.fused_dynamic_matmul import (
    fused_dynamic_cases,
    fused_dynamic_gemm,
    fused_dynamic_gemm_plain,
)
from quantnet_torch.ops.int8_matmul import (
    Epilogue,
    int8_gemm,
    int8_gemm_epilogue,
    int8_gemm_epilogue_plain,
    int8_gemm_plain,
    requantize,
    requantize_cases,
)
from quantnet_torch.ops.residual_boundary import residual_boundary, residual_boundary_plain
from quantnet_torch.quantize import dynamic, static

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# The convnet's six conv GEMMs at bs1024 (conv1's K = 27 as the wrapper takes
# it, padded to 32 inside) and ResNet-50's 20 GEMM shapes at bs128, 224x224.
CONVNET_GEMMS = [(1048576, 27, 64), (1048576, 576, 64), (262144, 576, 128), (262144, 1152, 128),
                 (65536, 1152, 256), (65536, 2304, 256)]
RESNET50_GEMMS = [(128, 2048, 1000), (6272, 512, 2048), (6272, 1024, 2048), (6272, 2048, 512),
                  (6272, 4608, 512), (25088, 256, 1024), (25088, 512, 1024), (25088, 1024, 256),
                  (25088, 1024, 512), (25088, 2304, 256), (100352, 128, 512), (100352, 256, 512),
                  (100352, 512, 128), (100352, 512, 256), (100352, 1152, 128), (401408, 64, 64),
                  (401408, 64, 256), (401408, 256, 64), (401408, 256, 128), (401408, 576, 64)]
# Ragged shapes: M, N and K off every tile and vector step.
RAGGED_GEMMS = [(48, 200, 136), (7, 33, 5), (1, 16, 1), (300, 27, 64), (4096, 576, 64),
                (129, 2304, 256), (513, 130, 130), (200, 64, 520), (65, 1000, 300)]


@pytest.mark.parametrize("m,k,n", RAGGED_GEMMS + CONVNET_GEMMS + RESNET50_GEMMS)
def test_int8_gemm_exact(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    before = int8_gemm.launches
    got = int8_gemm(a, b)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1
    assert torch.equal(got, int8_gemm_plain(a, b))


# K2 at the convnet's fc1 and fc2 (the bench's batch, the serving batch and
# one row), and ragged shapes: M off the 64-row tile, K off the 128-wide step
# and past 8 K-blocks, N off every width (10, 130) and past one 512-wide tile.
FUSED_SHAPES = [(1024, 4096, 512), (1024, 512, 10), (32, 4096, 512), (32, 512, 10), (1, 4096, 512),
                (1, 512, 10), (7, 600, 10), (33, 100, 130), (65, 4224, 520), (129, 600, 130),
                (7, 4224, 10), (33, 100, 520), (65, 600, 10), (129, 4224, 130)]


def _bits_equal(got, ref):
    """The same f32 bits (compared as integers, so -0 and +0 count as different)."""
    return torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", FUSED_SHAPES)
def test_fused_dynamic_gemm_matches_plain(dev, m, k, n, dtype, relu):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device=dev) * 1e-2
    b = torch.randn((n,), generator=g, device=dev)
    before = fused_dynamic_gemm.launches
    got = fused_dynamic_gemm(x, w, ws, b, relu)
    torch.cuda.synchronize()
    assert fused_dynamic_gemm.launches == before + 1
    assert _bits_equal(got, fused_dynamic_gemm_plain(x, w, ws, b, relu))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(64, 4096, 512), (96, 1024, 10), (33, 600, 130)])
def test_fused_dynamic_gemm_ties_and_eps_floor(dev, m, k, n, dtype, relu):
    """The kernel's quantize (its fast division among it) on x at the
    rounding ties of x / s, under the 1e-8 floor of the scale, subnormal,
    zero, past the fast division's range and over every bf16 exponent."""
    g = torch.Generator(device=dev).manual_seed(m * k + n)
    x = fused_dynamic_cases(m, k, dtype, dev)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand((n,), generator=g, device=dev) * 1e-2 + 1e-4
    b = torch.randn((n,), generator=g, device=dev)
    got = fused_dynamic_gemm(x, w, ws, b, relu)
    torch.cuda.synchronize()
    assert _bits_equal(got, fused_dynamic_gemm_plain(x, w, ws, b, relu))


def _epilogues(dev, g, m, n):
    """Every store, with and without zpw, bias, relu and a per-row scale."""
    cs = torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-5
    bias = torch.randn((n,), generator=g, device=dev)
    zpw = torch.randint(-20000, 20000, (n,), generator=g, device=dev, dtype=torch.int32)
    rs = torch.rand((m,), generator=g, device=dev) * 1e-2 + 1e-4
    aq = ActQuant(torch.tensor(0.0123, device=dev), torch.tensor(-7, dtype=torch.int32, device=dev))
    return {
        "f32": Epilogue(cs=cs),
        "f32_zpw_bias_relu": Epilogue(cs=cs, bias=bias, zpw=zpw, relu=True),
        "f32_rs_bias": Epilogue(cs=cs, bias=bias, rs=rs),
        "bf16_bias_relu": Epilogue(cs=cs, bias=bias, relu=True, out=torch.bfloat16),
        "bf16_rs": Epilogue(cs=cs, rs=rs, out=torch.bfloat16),
        "int8_zpw_bias_relu": Epilogue(cs=cs, bias=bias, zpw=zpw, relu=True, out=torch.int8, out_quant=aq),
        "int8_zpw": Epilogue(cs=cs, zpw=zpw, out=torch.int8, out_quant=aq),
        "int8_bias": Epilogue(cs=cs, bias=bias, out=torch.int8, out_quant=aq),
    }


@pytest.mark.parametrize("store", ["f32", "f32_zpw_bias_relu", "f32_rs_bias", "bf16_bias_relu",
                                   "bf16_rs", "int8_zpw_bias_relu", "int8_zpw", "int8_bias"])
@pytest.mark.parametrize("m,k,n", [(7, 48, 5), (300, 27, 64), (1000, 576, 128), (513, 256, 256),
                                   (129, 2048, 1000), (4096, 1152, 2048), (65536, 2304, 256)])
def test_int8_gemm_epilogue_bit_equal(dev, m, k, n, store):
    """Each store of the fused kernel against int8_gemm_epilogue_plain: the
    same bits (compared as integers, so -0 and +0 count as different)."""
    g = torch.Generator(device=dev).manual_seed(m + 3 * k + 7 * n)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    epi = _epilogues(dev, g, m, n)[store]
    before = int8_gemm.launches
    got = int8_gemm_epilogue(a, b, epi)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1
    ref = int8_gemm_epilogue_plain(a, b, epi)
    assert got.dtype == ref.dtype == epi.out and got.shape == ref.shape
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.int8: torch.int8}[epi.out]
    assert torch.equal(got.contiguous().view(bits), ref.view(bits))


@pytest.mark.parametrize("scale,zp", [(0.061, -128), (0.0123, -7), (1e-8, 0), (0.37, 5),
                                      (7.0, 127), (2.0**-70, 3)])
def test_requantize_division_matches_quantize_affine(dev, scale, zp):
    """The int8 store's branch-free division (with its fallback) against
    PyTorch's true division in quantize_affine, on 2.1M inputs."""
    y = requantize_cases(scale, dev)
    aq = ActQuant(torch.tensor(scale, device=dev), torch.tensor(zp, dtype=torch.int32, device=dev))
    got = requantize(y, aq)
    torch.cuda.synchronize()
    assert torch.equal(got, quantize_affine(y, aq.scale, aq.zero_point))


def test_wrapper_rejects_non_contiguous(dev):
    a = torch.zeros((8, 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        int8_gemm(a[:, ::2], a[:, ::2].contiguous())


@pytest.mark.parametrize("batch", [1024, 32])
@pytest.mark.parametrize("linear,launches", [("fused", (6, 2)), ("unfused", (8, 0))])
def test_model_goes_through_the_kernels(dev, linear, launches, batch):
    """The dynamic convnet at the bench's and the serving batch: the six
    convs through K1 with the bf16 store, the fc layers through K2 with fc1's
    relu in its store (or K1 with the per-row scale and f32 store); the
    logits are the plain-version forward's bits."""
    params, state = convnet.init(torch.Generator().manual_seed(0), device=dev)
    q, qs = dynamic.quantize(params, state)
    x = torch.randn((batch, 32, 32, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    flags = Flags(dynamic_linear=linear)
    int8_gemm.launches = fused_dynamic_gemm.launches = 0
    got, _ = convnet.apply(q, qs, x, flags=flags)
    assert (int8_gemm.launches, fused_dynamic_gemm.launches) == launches
    ref, _ = convnet.apply(q, qs, x, flags=Flags(dynamic_linear=linear, plain=True))
    assert torch.equal(got, ref)


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
    # 19 int8 convs (the stem stays fp32) + fc, each one fused K1 launch
    # storing the layer's own output type; 7 of 8 blocks hand int8 on.
    assert (int8_gemm.launches, residual_boundary.launches) == (20, 7)
    ref, _ = resnet.apply(q, qs, x, flags=Flags(plain=True))
    assert torch.equal(got, ref)


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


@pytest.mark.parametrize("skip_first_layer,launches", [(True, 7), (False, 8)])
def test_static_convnet_goes_through_the_kernels(dev, skip_first_layer, launches):
    """The convnet's static sibling: every int8 layer one fused K1 launch,
    int8 handed from layer to layer; the logits are the plain run's bits."""
    from quantnet_torch.entry import static_entry

    fn, (q, qs, x) = static_entry(dev, batch_size=64, calibration_size=8,
                                  skip_first_layer=skip_first_layer)
    int8_gemm.launches = fused_dynamic_gemm.launches = 0
    got = fn(q, qs, x)
    assert (int8_gemm.launches, fused_dynamic_gemm.launches) == (launches, 0)
    ref, _ = convnet.apply(q, qs, x, flags=Flags(plain=True))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("scheme", ["bf16", "weight_only", "weight_only_int4"])
def test_float_products_keep_f32(dev, scheme, tmp_path):
    """Each layer of the bf16 and weight-only schemes on the card against the
    same layer on the CPU, on the same input and weights (the tree is built
    on the CPU and loaded onto the card as an artifact: a tree built on the
    card folds BN with the card's rsqrt, an ulp apart, which moves a weight's
    rounding now and then). Bound 1e-5 x max|y|, f32 order: TF32 measured
    3e-4 on the card, and a product rounded to bf16 is about 4e-3 off. The
    caller's TF32 settings are left as they were."""
    from quantnet_torch.models.convnet import QUANT_LAYERS
    from quantnet_torch.ops.conv import conv2d
    from quantnet_torch.ops.linear import linear
    from quantnet_torch.quantize import bf16, weight_only
    from quantnet_torch.train.checkpoint import load_artifact, save_artifact

    transform = {"bf16": bf16.quantize, "weight_only": weight_only.quantize,
                 "weight_only_int4": lambda p, s: weight_only.quantize(p, s, bits=4, group_size=128)}
    params, state = convnet.init(torch.Generator().manual_seed(0), device="cpu")
    q, _ = transform[scheme](params, state)
    save_artifact(str(tmp_path / scheme), q)
    on_card, _ = load_artifact(str(tmp_path / scheme), device=dev)
    x = torch.randn((16, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    inputs = {}
    convnet.apply(q, {}, x, capture=inputs)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for name in QUANT_LAYERS:
        op = conv2d if name.startswith("conv") else linear
        ref = op(q[name], inputs[name], activation="relu")
        got = op(on_card[name], inputs[name].to(dev), activation="relu")
        assert got.dtype == torch.float32, name
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-5 * ref.abs().max().item(), msg=name)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


def test_artifact_round_trip_on_the_card(dev, tmp_path):
    from quantnet_torch.train.checkpoint import load_artifact, save_artifact

    params, state = convnet.init(torch.Generator().manual_seed(0), device=dev)
    q, qs = dynamic.quantize(params, state)
    x = torch.randn((32, 32, 32, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    before, _ = convnet.apply(q, qs, x)
    save_artifact(str(tmp_path / "dynamic"), {"params": q, "state": qs})
    tree, _ = load_artifact(str(tmp_path / "dynamic"), device=dev)
    assert tree["params"]["fc1"]["w"].values.is_cuda
    after, _ = convnet.apply(tree["params"], tree["state"], x)
    assert torch.equal(before, after)


@pytest.mark.parametrize("scheme,launches", [("static", {"int8_gemm": 7}),
                                             ("dynamic", {"int8_gemm": 6, "fused_dynamic_gemm": 2})])
def test_engine_graph_replay_bit_equal_to_eager(dev, scheme, launches):
    """The serving engine captures every bucket's forward (the u8 wire's
    normalization included) in a CUDA graph: each replay is bit-equal to an
    eager forward of the same batch and launches the path's kernels, counted
    in a device trace (K2 under capture too, with its own workspace); served
    requests get the replay's logits."""
    import numpy as np

    from quantnet_torch.bench.trace import kernel_launches, trace
    from quantnet_torch.serve import InferenceEngine

    params, state = convnet.init(torch.Generator().manual_seed(0), image_size=16, device=dev)
    if scheme == "static":
        calib = torch.randn((8, 16, 16, 3), generator=torch.Generator().manual_seed(1)).to(dev)
        q, qs = static.quantize(params, state, convnet.apply, [calib], skip_first_layer=True)
    else:
        q, qs = dynamic.quantize(params, state)
    norm = ((0.49, 0.48, 0.45), (0.25, 0.24, 0.26))
    g = torch.Generator().manual_seed(2)
    with InferenceEngine(convnet.apply, q, qs, image_shape=(16, 16, 3), buckets=(1, 8, 32),
                         max_wait_ms=500, device=dev, wire_dtype="uint8", normalize=norm) as eng:
        for b in eng.buckets:
            x = torch.randint(0, 256, (b, 16, 16, 3), generator=g, dtype=torch.uint8).to(dev)
            assert torch.equal(eng.replay(x), eng.forward(x)), b
            per = kernel_launches(trace(lambda: eng.replay(x))[1])
            assert {k: n for k, n in per.items() if n} == launches, (b, per)
        imgs = np.random.default_rng(3).integers(0, 256, (32, 16, 16, 3), dtype=np.uint8)
        futs = [eng.submit(img) for img in imgs]
        got = np.stack([f.result(timeout=60) for f in futs])
        assert eng.stats["batches"] == 1  # all 32 within one coalescing window
        want = eng.forward(torch.from_numpy(imgs).to(dev)).cpu().numpy()
    np.testing.assert_array_equal(got, want)
