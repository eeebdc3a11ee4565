"""The s4 runtime payload against the JAX package's (quantnet/quantize/
common.py:90-113, tests/test_int4.py:352-400).

`s4_runtime_tree` packs every 4-bit weight two to a byte (two's-complement
nibbles along K, the even k low) and K1 reads the packed operand itself
(its packed-B mode; here its plain version): the forwards are bit-identical
to the int8-wide tree's, as the JAX test requires of its int4 payload, and
held against the JAX package's s4 forwards within the tolerances its
one-rank tests use. No int8-wide copy of a 4-bit weight stays in the tree,
and a 4-bit layer that no route takes packed raises.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.models import convnet as jconvnet
from quantnet.quantize import static as jstatic
from quantnet.quantize import weight_only as jweight_only
from quantnet.quantize.common import s4_runtime_tree as js4_runtime_tree
from quantnet_torch import interop
from quantnet_torch.cli.main import main
from quantnet_torch.core.config import Flags
from quantnet_torch.core.types import (
    ActQuant,
    DynamicActQuant,
    QTensor,
    pack_nibbles,
    unpack_nibbles,
)
from quantnet_torch.models import convnet, mobilenet, resnet
from quantnet_torch.ops import linear as tlinear
from quantnet_torch.ops.int8_matmul import (
    Epilogue,
    int8_gemm,
    int8_gemm_epilogue,
    int8_gemm_epilogue_plain,
    int8_gemm_plain,
)
from quantnet_torch.ops.linear import gemm_constants
from quantnet_torch.quantize import static, weight_only
from quantnet_torch.quantize.common import quantize_weight, s4_runtime_tree
from test_torch_convnet import jit_unfused
from test_torch_cli import CKPT, _dirs

IMAGE = 16


def _rng_values(shape, seed, lo=-8, hi=8):
    return torch.from_numpy(np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int8))


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 27, 31, 32, 33, 100, 128])
def test_pack_unpack_round_trip(k):
    v = _rng_values((5, k), k)
    p = pack_nibbles(v)
    assert p.dtype == torch.uint8 and p.shape == (5, -(-k // 32) * 16)
    assert torch.equal(unpack_nibbles(p, k), v)
    # The padding past K is zero nibbles.
    assert not unpack_nibbles(p)[:, k:].any()


def test_nibble_layout_and_zero_bytes():
    """Two's complement, the even k in the low nibble: -8..7 each; a zero
    byte (the kernel's fill past N and K) unpacks to two zeros."""
    v = torch.arange(-8, 8, dtype=torch.int8).repeat(2).reshape(1, 32)
    p = pack_nibbles(v)
    assert p[0, 0].item() == (0x8 | (0x9 << 4)) and p[0, 4].item() == (0x0 | (0x1 << 4))
    assert torch.equal(unpack_nibbles(p), v)
    assert torch.equal(unpack_nibbles(torch.zeros((3, 16), dtype=torch.uint8)),
                       torch.zeros((3, 32), dtype=torch.int8))


# ---------------------------------------------------------------------------
# K1's packed mode (the plain version on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(7, 27, 5), (16, 100, 33), (9, 128, 64), (3, 576, 10)])
def test_plain_packed_k1_equals_int8_wide(m, k, n):
    a = _rng_values((m, k), 1, -128, 128)
    b = _rng_values((n, k), 2, -7, 8)
    packed = pack_nibbles(b)
    assert torch.equal(int8_gemm(a, packed), int8_gemm(a, b))
    assert torch.equal(int8_gemm_plain(a, packed), int8_gemm_plain(a, b))
    r = np.random.default_rng(3)
    cs = torch.from_numpy(r.random(n).astype(np.float32) * 1e-3)
    bias = torch.from_numpy(r.standard_normal(n).astype(np.float32))
    zpw = torch.from_numpy(r.integers(-500, 500, n).astype(np.int32))
    oq = ActQuant(scale=torch.tensor(0.05), zero_point=torch.tensor(-3, dtype=torch.int32))
    for epi in (Epilogue(cs=cs, bias=bias, zpw=zpw, act="relu"),
                Epilogue(cs=cs, bias=bias, act="relu6", out=torch.bfloat16),
                Epilogue(cs=cs, zpw=zpw, out=torch.int8, out_quant=oq)):
        assert torch.equal(int8_gemm_epilogue(a, packed, epi), int8_gemm_epilogue(a, b, epi))


@pytest.mark.parametrize("k,group", [(96, 32), (256, 128), (80, 16)])
def test_plain_packed_k1_grouped_equals_int8_wide(k, group):
    """The grouped-K mode, the group a multiple of 32 (the card's) and not
    (the plain version's only), K not a multiple of 32 included."""
    m, n = 7, 33
    a = _rng_values((m, k), 4, -128, 128)
    b = _rng_values((n, k), 5, -7, 8)
    r = np.random.default_rng(6)
    g = k // group
    epi = Epilogue(cs=torch.full((n,), 0.03), bias=torch.ones(n), act="relu", group=group,
                   gs=torch.from_numpy(r.random((g, n)).astype(np.float32) * 1e-2),
                   gzpw=torch.from_numpy(r.integers(-3000, 3000, (g, n)).astype(np.int32)))
    packed = pack_nibbles(b)
    assert torch.equal(int8_gemm_epilogue(a, packed, epi), int8_gemm_epilogue_plain(a, b, epi))


def test_packed_operand_checked():
    a = _rng_values((4, 40), 7, -128, 128)
    with pytest.raises(ValueError, match="packed"):
        int8_gemm(a, pack_nibbles(_rng_values((3, 80), 8)))  # K' = 96 is past 40 + 32
    with pytest.raises(TypeError):
        int8_gemm(a, torch.zeros((3, 40), dtype=torch.int16))


# ---------------------------------------------------------------------------
# s4_runtime_tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    params, state = convnet.init(torch.Generator().manual_seed(0), image_size=IMAGE, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((8, IMAGE, IMAGE, 3))
                         .astype(np.float32))
    wo = weight_only.quantize(params, state, bits=4, group_size=128,
                              layer_policy={"conv2": "int8"})[0]
    w4 = static.quantize(params, state, convnet.apply, [x], weight_bits=4, weight_group_size=128,
                         skip_first_layer=True)[0]
    return x, wo, w4


def _layers(tree):
    return {k: v for k, v in tree.items() if isinstance(v, dict) and isinstance(v.get("w"), QTensor)}


def test_payload_dtype_and_shapes(trees):
    """Every 4-bit payload packed, uint8[N, K'/2], with its logical shape and
    disk size; 8-bit (here int4-guarded) layers untouched; K1's operand is the
    packed payload itself, and no int8-wide copy of the weight is left."""
    _, wo, w4 = trees
    for tree in (wo, w4):
        s4 = s4_runtime_tree(tree)
        for name, layer in _layers(tree).items():
            w, p = layer["w"], s4[name]["w"]
            if w.bits == 8:
                assert p is w, name
                continue
            n, k = w.shape[-1], int(np.prod(w.shape[:-1]))
            assert p.is_packed and p.values.dtype == torch.uint8, name
            assert p.values.shape == (n, -(-k // 32) * 16) and p.shape == w.shape, name
            assert p.nbytes == w.nbytes and p.bits == 4 and p.group_size == w.group_size
            assert torch.equal(p.int8_values(), w.values), name
            assert p._nk is None
            g = s4[name].get("gemm")
            if g is not None:
                assert g.b_nk is p.values and g.w_nk is None, name
    assert s4_runtime_tree(wo)["conv2"]["w"].bits == 8


def test_weight_only_int4_forward_identical(trees):
    x, wo, _ = trees
    assert torch.equal(convnet.apply(s4_runtime_tree(wo), {}, x)[0], convnet.apply(wo, {}, x)[0])


def test_w4a8_forward_identical_and_k1_takes_the_packed_operand(trees, monkeypatch):
    x, _, w4 = trees
    seen = []
    plain = tlinear.int8_gemm_epilogue_plain

    def spy(a, b, epi):
        seen.append(b.dtype)
        return plain(a, b, epi)

    want = convnet.apply(w4, {}, x, flags=Flags(plain=True))[0]
    monkeypatch.setattr(tlinear, "int8_gemm_epilogue_plain", spy)
    got = convnet.apply(s4_runtime_tree(w4), {}, x, flags=Flags(plain=True))[0]
    assert torch.equal(got, want)
    # conv2-conv6, fc1 and fc2: every K1 launch got the packed weight.
    assert seen == [torch.uint8] * 7


def test_resnet_and_mobilenet_w4a8_forwards_identical():
    """ResNet (K1 and K3) and MobileNetV2 (K1 and K4, whose depthwise weight
    is widened into a transient int8 tensor) at a small size."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 32, 32, 3)).astype(np.float32))
    for model, init in ((resnet, dict(depth=18, num_classes=10)),
                        (mobilenet, dict(num_classes=10, width_mult=0.35))):
        p, s = model.init(torch.Generator().manual_seed(0), device="cpu", **init)
        q, qs = static.quantize(p, s, model.apply, [x], weight_bits=4, weight_group_size=128)
        assert torch.equal(model.apply(s4_runtime_tree(q), qs, x)[0], model.apply(q, qs, x)[0])


def test_a_packed_layer_without_a_route_raises():
    """The fused dynamic GEMM takes int8-wide weights: a packed 4-bit dynamic
    layer raises there, and runs K1's packed mode on the per-row route."""
    r = np.random.default_rng(9)
    w = torch.from_numpy(r.standard_normal((64, 16)).astype(np.float32))
    layer = {"w": quantize_weight(w, True, bits=4), "b": torch.zeros(16), "aq": DynamicActQuant()}
    layer["gemm"] = gemm_constants(layer)
    packed = dict(layer, w=layer["w"].packed())
    packed["gemm"] = gemm_constants(packed)
    x = torch.from_numpy(r.standard_normal((4, 64)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="no route"):
        tlinear.linear(packed, x)
    unfused = Flags(dynamic_linear="unfused")
    assert torch.equal(tlinear.linear(packed, x, flags=unfused), tlinear.linear(layer, x, flags=unfused))


# ---------------------------------------------------------------------------
# Against the JAX package's s4 forwards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_trees():
    params, state = jconvnet.init(jax.random.PRNGKey(0), image_size=IMAGE)
    x = np.random.default_rng(5).standard_normal((8, IMAGE, IMAGE, 3)).astype(np.float32)
    wo, _ = jweight_only.quantize(params, state, bits=4, group_size=128)
    w4, _ = jstatic.quantize(params, state, jconvnet.apply, [(x, None)], weight_bits=4,
                             weight_group_size=128, skip_first_layer=True)
    return x, {"weight_only_int4": wo, "w4a8": w4}


@pytest.mark.parametrize("name,rtol", [("weight_only_int4", 1e-5), ("w4a8", 0.0)])
def test_s4_forward_matches_jax_s4(monkeypatch, jax_trees, name, rtol):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")
    x, jt = jax_trees
    jq = jt[name]
    ref = np.asarray(jconvnet.apply(js4_runtime_tree(jq), {}, jnp.asarray(x))[0])
    want = np.asarray(jit_unfused(lambda q, xx: jconvnet.apply(q, {}, xx)[0], jq, jnp.asarray(x)))
    tq = s4_runtime_tree(interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu"))
    got = convnet.apply(tq, {}, torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())
    # The JAX s4 forward (eager) agrees with its jitted int8-wide one to f32 order.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# bench --s4-runtime
# ---------------------------------------------------------------------------


def test_cli_bench_s4_runtime(tmp_path):
    d = _dirs(tmp_path) + ["--synthetic-train-size", "64", "--synthetic-test-size", "64",
                           "--device", "cpu"]
    main(["import-torch", "--ckpt", CKPT, *d])
    main(["quantize", "--scheme", "w4a8", "--batch-size", "32", "--calibration-batches", "1", *d])
    got = main(["bench", "--s4-runtime", "--batch-sizes", "1", "--iters", "1", "--warmup", "0", *d])
    assert set(got) == {"fp32", "w4a8"}
    assert json.loads((tmp_path / "results" / "benchmark.json").read_text()).keys() == {"fp32", "w4a8"}
    wide = main(["bench", "--batch-sizes", "1", "--iters", "1", "--warmup", "0", *d])
    assert got["w4a8"]["model_size_bytes"] == wide["w4a8"]["model_size_bytes"]
