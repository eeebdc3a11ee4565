"""quantnet_torch ops (layers, conv, linear) against the JAX package's.

The JAX int8 paths run on exact backends: `xla` (int8 x int8 -> int32) and
`pallas` / `im2col` in interpret mode. Integer work and the dynamic epilogues
are then bit-exact on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from quantnet.core import config as jcfg
from quantnet.core.quantize import quantize_symmetric as j_quantize_symmetric
from quantnet.core.types import DynamicActQuant as JDynamicActQuant
from quantnet.ops import conv as jconv
from quantnet.ops import layers as jlayers
from quantnet.ops import linear as jlinear
from quantnet_torch import interop
from quantnet_torch.core.config import Flags
from quantnet_torch.core.types import ActQuant, DynamicActQuant, QTensor
from quantnet_torch.ops import conv as tconv
from quantnet_torch.ops import layers as tlayers
from quantnet_torch.ops import linear as tlinear
from test_torch_convnet import jit_unfused


def _rng(seed):
    return np.random.default_rng(seed)


def _bn(c, seed):
    r = _rng(seed)
    params = {
        "gamma": (1 + 0.1 * r.standard_normal(c)).astype(np.float32),
        "beta": (0.1 * r.standard_normal(c)).astype(np.float32),
    }
    state = {
        "mean": (0.1 * r.standard_normal(c)).astype(np.float32),
        "var": (1 + 0.5 * r.random(c)).astype(np.float32),
    }
    return params, state


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_batchnorm_apply_matches():
    p, s = _bn(16, 0)
    x = _rng(1).standard_normal((2, 4, 4, 16)).astype(np.float32)
    ref, _ = jlayers.batchnorm_apply(_j(p), _j(s), jnp.asarray(x), train=False)
    got = tlayers.batchnorm_apply(_t(p), _t(s), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (64, 32)])
def test_fold_batchnorm_matches(shape):
    """Folded weights agree to an ulp or two: XLA's and PyTorch's rsqrt may
    round differently in the last place."""
    c = shape[-1]
    p, s = _bn(c, 2)
    w = _rng(3).standard_normal(shape).astype(np.float32)
    b = _rng(4).standard_normal(c).astype(np.float32)
    jw, jb = jlayers.fold_batchnorm_into_conv(jnp.asarray(w), jnp.asarray(b), _j(p), _j(s))
    tw, tb = tlayers.fold_batchnorm_into_conv(torch.from_numpy(w), torch.from_numpy(b), _t(p), _t(s))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=3e-7, atol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=3e-7, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(8, 8), (7, 5)])
def test_maxpool2d_matches_exactly(dtype, hw):
    x = _rng(5).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = jlayers.maxpool2d(jnp.asarray(x).astype(dtype))
    got = tlayers.maxpool2d(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("size,k,stride", [(8, 3, 1), (7, 3, 2), (6, 1, 1), (5, 4, 2)])
def test_same_pads_and_im2col_match(size, k, stride):
    assert tconv._same_pads(size, size + 1, k, k, stride) == jconv._same_pads(
        size, size + 1, k, k, stride
    )
    x = _rng(6).integers(-127, 128, (2, size, size + 1, 3)).astype(np.int8)
    ref = jconv._im2col(jnp.asarray(x), k, k, stride)
    got = tconv._im2col(torch.from_numpy(x), k, k, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _dynamic_layer(w_shape, seed, handoff="bfloat16"):
    r = _rng(seed)
    w = (r.standard_normal(w_shape) * 0.1).astype(np.float32)
    b = (r.standard_normal(w_shape[-1]) * 0.1).astype(np.float32)
    jlayer = {
        "w": j_quantize_symmetric(jnp.asarray(w), axis=len(w_shape) - 1),
        "b": jnp.asarray(b),
        "aq": JDynamicActQuant(handoff=handoff),
    }
    tlayer = interop.from_jax_qparams({"l": jax.tree.map(np.asarray, jlayer)}, device="cpu")["l"]
    return jlayer, tlayer


def _backend(monkeypatch, matmul, conv):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", matmul)
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", conv)


@pytest.mark.parametrize("backend", [("xla", "xla"), ("pallas", "im2col")])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_dynamic_conv2d_bit_exact(monkeypatch, backend, in_dtype):
    """Per-tensor quant, int8 conv, f32 epilogue, relu, bf16 handoff: the same
    bits as the JAX package, jitted as it runs (the activation scale's
    / 127 is a multiply by f32(1 / 127) there), on either exact int8 backend."""
    _backend(monkeypatch, *backend)
    jlayer, tlayer = _dynamic_layer((3, 3, 8, 16), 7)
    x = _rng(8).standard_normal((2, 6, 6, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jit_unfused(lambda layer, xx: jconv.conv2d(layer, xx, activation="relu"),
                          jlayer, jnp.asarray(x).astype(in_dtype))
    got = tconv.conv2d(tlayer, torch.from_numpy(x).to(getattr(torch, in_dtype)), activation="relu")
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_fp32_conv2d_matches():
    r = _rng(9)
    layer = {"w": r.standard_normal((3, 3, 4, 8)).astype(np.float32),
             "b": r.standard_normal(8).astype(np.float32)}
    x = r.standard_normal((2, 5, 7, 4)).astype(np.float32)
    ref = jconv.conv2d(_j(layer), jnp.asarray(x), activation="relu")
    got = tconv.conv2d(_t(layer), torch.from_numpy(x), activation="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("handoff,activation", [("bfloat16", "relu"), (None, None)])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_unfused_dynamic_linear_bit_exact(monkeypatch, handoff, activation, in_dtype):
    """Per-row quant, int8 GEMM, f32 epilogue, handoff: the JAX `xla` path."""
    _backend(monkeypatch, "xla", "xla")
    jlayer, tlayer = _dynamic_layer((96, 24), 10, handoff)
    x = _rng(11).standard_normal((5, 96)).astype(np.float32)
    ref = jlinear.linear(jlayer, jnp.asarray(x).astype(in_dtype), activation=activation)
    got = tlinear.linear(tlayer, torch.from_numpy(x).to(getattr(torch, in_dtype)),
                         activation=activation, flags=Flags(dynamic_linear="unfused"))
    assert str(got.dtype).rsplit(".", 1)[-1] == str(ref.dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("k", [96, 1024])
def test_fused_dynamic_linear_matches_pallas_on_f32_input(monkeypatch, k):
    """The fused path on f32 input (the kernel's contract): float order only.
    It writes f32 whatever the handoff, as the JAX fused path does."""
    _backend(monkeypatch, "pallas", "im2col")
    jlayer, tlayer = _dynamic_layer((k, 24), 12)
    x = _rng(13).standard_normal((5, k)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jlinear.linear(jlayer, jnp.asarray(x), activation="relu")
    got = tlinear.linear(tlayer, torch.from_numpy(x), activation="relu")
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


def test_fp32_linear_matches():
    r = _rng(14)
    layer = {"w": r.standard_normal((32, 8)).astype(np.float32),
             "b": r.standard_normal(8).astype(np.float32)}
    x = r.standard_normal((4, 32)).astype(np.float32)
    ref = jlinear.linear(_j(layer), jnp.asarray(x), activation="relu")
    got = tlinear.linear(_t(layer), torch.from_numpy(x), activation="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_unported_paths_raise():
    """Grouped weights have no route but the weight-only one: a grouped conv
    raises, as in the JAX package, and so does a grouped dense weight on the
    dynamic path and on the static (W4A8) path, which needs a batched int8
    GEMM kernel."""
    q = QTensor(values=torch.zeros((4, 2), dtype=torch.int8), scale=torch.ones(2, 1, 2), group_size=2)
    with pytest.raises(NotImplementedError, match="group-wise"):
        tlinear.linear({"w": q, "aq": DynamicActQuant()}, torch.zeros((1, 4)))
    aq = ActQuant(torch.tensor(0.1), torch.tensor(0, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="batched int8 GEMM"):
        tlinear.linear({"w": q, "aq": aq}, torch.zeros((1, 4)))
    qc = QTensor(values=torch.zeros((3, 3, 1, 2), dtype=torch.int8), scale=torch.ones(1, 1, 1, 2),
                 group_size=1)
    with pytest.raises(NotImplementedError, match="group-wise"):
        tconv.conv2d({"w": qc}, torch.zeros((1, 4, 4, 1)))
    with pytest.raises(ValueError):
        Flags(dynamic_linear="xla")
