"""Weight-only quantization and the dynamic policy table against the JAX
package: grouped and int4 weight quantization, the weight-only and dynamic
transforms, and the weight-only conv and linear.

The transforms are compared bit for bit with the jitted JAX transforms on
the same BN-folded tree (XLA takes `amax / 7` and `amax / 127` as multiplies
by the f32 reciprocal there, and so does the port). The weight-only products
run outside Pallas in the JAX package: they agree to f32 summation order,
rtol 1e-5 with atol 1e-5 x max|y|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import quantize as jquantize
from quantnet.models import convnet as jconvnet
from quantnet.ops import conv as jconv
from quantnet.ops import linear as jlinear
from quantnet.quantize import common as jcommon
from quantnet.quantize import dynamic as jdynamic
from quantnet.quantize import fold as jfold
from quantnet.quantize import weight_only as jweight_only
from quantnet_torch import interop
from quantnet_torch.core import quantize as tquantize
from quantnet_torch.core.types import ActQuant, DynamicActQuant, QTensor
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.ops import conv as tconv
from quantnet_torch.ops import linear as tlinear
from quantnet_torch.quantize import common as tcommon
from quantnet_torch.quantize import dynamic as tdynamic
from quantnet_torch.quantize import weight_only as tweight_only
from test_torch_convnet import jit_unfused

IMAGE = 16


def _w(shape, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) * 0.05).astype(np.float32)


def _same_qtensor(got, ref, name=""):
    assert isinstance(got, QTensor), name
    assert (got.axis, got.bits, got.group_size) == (ref.axis, ref.bits, ref.group_size), name
    assert (got.zero_point is None) == (ref.zero_point is None), name
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values), err_msg=name)
    assert tuple(got.scale.shape) == ref.scale.shape, name
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale), err_msg=name)


@pytest.mark.parametrize("shape,group,bits", [((4096, 512), 128, 4), ((512, 10), 64, 4),
                                              ((1024, 512), 128, 8), ((256, 3, 5), 32, 4)])
def test_quantize_symmetric_grouped_bit_exact(shape, group, bits):
    w = _w(shape, sum(shape))
    w[:group] = 0.0  # a group of zeros: the scale floors at EPS
    ref = jax.jit(jquantize.quantize_symmetric_grouped, static_argnums=(1, 2))(jnp.asarray(w), group, bits)
    got = tquantize.quantize_symmetric_grouped(torch.from_numpy(w), group, bits)
    _same_qtensor(got, ref)
    np.testing.assert_allclose(got.dequantize().numpy(), np.asarray(ref.dequantize()), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tquantize.quantize_symmetric_grouped(torch.from_numpy(w), group + 1, bits)


# (shape, per_channel, bits, group_size): grouped 2-D; a conv kernel and a K
# the group does not divide fall back to per channel; per tensor stays per
# tensor with a group size asked for.
WEIGHT_CASES = [((4096, 512), True, 4, 128), ((3, 3, 64, 128), True, 4, 128),
                ((500, 10), True, 4, 128), ((512, 10), False, 4, 128), ((512, 10), True, 8, None),
                ((3, 3, 3, 64), True, 4, None)]


@pytest.mark.parametrize("shape,per_channel,bits,group", WEIGHT_CASES)
def test_quantize_weight_matches_jax(shape, per_channel, bits, group):
    w = _w(shape, len(shape) + bits)
    fn = jax.jit(jcommon.quantize_weight, static_argnums=(1, 2, 3))
    ref = fn(jnp.asarray(w), per_channel, bits, group)
    got = tcommon.quantize_weight(torch.from_numpy(w), per_channel, bits=bits, group_size=group)
    _same_qtensor(got, ref)
    assert got.nbytes == ref.nbytes


@pytest.fixture(scope="module")
def folded():
    params, state = jconvnet.init(jax.random.PRNGKey(3), image_size=IMAGE)
    jf, _ = jfold.fold_model_jit(params, state)
    return jf, interop.from_jax_params(jax.tree.map(np.asarray, jf), {}, device="cpu")[0]


# (bits, group_size, layer_policy, skip_last_layer, last_layer_name)
WEIGHT_ONLY_CASES = [
    (8, None, None, True, None),
    (4, 128, None, True, None),
    (4, 128, {"conv1": "int8", "fc1": "int8", "conv6": "fp32"}, True, None),
    (8, None, {"fc2": "weight_only"}, False, "fc1"),
]


@pytest.mark.parametrize("bits,group,policy,skip_last,last", WEIGHT_ONLY_CASES)
def test_weight_only_transform_matches_jax(folded, bits, group, policy, skip_last, last):
    jf, tf = folded
    ref, _ = jweight_only.quantize(jf, {}, bits=bits, group_size=group, layer_policy=policy,
                                   skip_last_layer=skip_last, last_layer_name=last)
    got, got_state = tweight_only.quantize(tf, {}, bits=bits, group_size=group, layer_policy=policy,
                                           skip_last_layer=skip_last, last_layer_name=last)
    assert got_state == {} and set(got) == set(ref)
    for name, layer in ref.items():
        assert set(got[name]) == set(layer), name
        if isinstance(layer["w"], jax.Array):
            assert isinstance(got[name]["w"], torch.Tensor), name
            np.testing.assert_array_equal(got[name]["w"].numpy(), np.asarray(layer["w"]))
        else:
            _same_qtensor(got[name]["w"], layer["w"], name)
    with pytest.raises(ValueError):
        tweight_only.quantize(tf, {}, bits=2)


@pytest.mark.parametrize("bits,group", [(8, None), (4, 128)])
def test_weight_only_model_matches_jax(folded, bits, group):
    """The whole weight-only convnet (fc1 grouped at int4) against the jitted
    JAX forward on the same tree: f32 order (the port's cuDNN / oneDNN and
    XLA's convs sum in different orders)."""
    jf, tf = folded
    jq, _ = jweight_only.quantize(jf, {}, bits=bits, group_size=group)
    tq, _ = tweight_only.quantize(tf, {}, bits=bits, group_size=group)
    x = np.random.default_rng(4).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    ref = np.asarray(jit_unfused(lambda q, x: jconvnet.apply(q, {}, x)[0], jq, jnp.asarray(x)))
    got, _ = tconvnet.apply(tq, {}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# (layer_policy, skip_first_layer, skip_last_layer, last_layer_name): an
# explicit entry wins over the skip flags; 'fp32' keeps a layer in fp32.
DYNAMIC_CASES = [
    ({"conv1": "fp32", "fc2": "dynamic"}, False, True, None),
    ({"conv1": "dynamic"}, True, False, None),
    (None, True, True, None),
    (None, False, False, "fc1"),
]


@pytest.mark.parametrize("policy,skip_first,skip_last,last", DYNAMIC_CASES)
def test_dynamic_policy_matches_jax(folded, policy, skip_first, skip_last, last):
    jf, tf = folded
    kwargs = dict(layer_policy=policy, skip_first_layer=skip_first, skip_last_layer=skip_last,
                  last_layer_name=last)
    ref, _ = jdynamic.quantize(jf, {}, **kwargs)
    got, _ = tdynamic.quantize(tf, {}, **kwargs)
    for name, layer in ref.items():
        aq = layer.get("aq")
        if aq is None:
            assert "aq" not in got[name] and "gemm" not in got[name], name
            np.testing.assert_array_equal(got[name]["w"].numpy(), np.asarray(layer["w"]))
        else:
            assert got[name]["aq"] == DynamicActQuant(aq.handoff), name
            _same_qtensor(got[name]["w"], layer["w"], name)
            assert "gemm" in got[name], name


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,group", [(8, None), (4, None), (4, 128)])
def test_weight_only_linear_matches_jax(x_dtype, bits, group):
    w = _w((1024, 96), bits)
    b = (np.random.default_rng(5).standard_normal(96) * 0.1).astype(np.float32)
    jl = {"w": jcommon.quantize_weight(jnp.asarray(w), True, bits, group), "b": jnp.asarray(b)}
    tl = interop.from_jax_qparams(jax.tree.map(np.asarray, jl), device="cpu")
    x = np.random.default_rng(6).standard_normal((7, 1024)).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
    ref = np.asarray(jax.jit(lambda layer, x: jlinear.linear(layer, x, activation="relu"))(jl, jx))
    got = tlinear.linear(tl, tx, activation="relu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,stride", [(8, 1), (4, 2)])
def test_weight_only_conv_matches_jax(x_dtype, bits, stride):
    w = _w((3, 3, 32, 48), bits + stride)
    jl = {"w": jcommon.quantize_weight(jnp.asarray(w), True, bits), "b": jnp.full((48,), 0.1)}
    tl = interop.from_jax_qparams(jax.tree.map(np.asarray, jl), device="cpu")
    x = np.random.default_rng(7).standard_normal((2, 9, 8, 32)).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
    fn = jax.jit(lambda layer, x: jconv.conv2d(layer, x, stride=stride, activation="relu"))
    ref = np.asarray(fn(jl, jx))
    got = tconv.conv2d(tl, tx, stride=stride, activation="relu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_weight_only_requantizes_into_a_static_consumer():
    """A weight-only producer hands int8 on in its consumer's domain: the
    int8 handoff of the static path (out_quant). The f32 products differ in
    summation order, so a value at a rounding tie may land one step apart."""
    w = _w((64, 32), 8)
    jl = {"w": jcommon.quantize_weight(jnp.asarray(w), True)}
    tl = interop.from_jax_qparams(jax.tree.map(np.asarray, jl), device="cpu")
    x = np.random.default_rng(9).standard_normal((5, 64)).astype(np.float32)
    from quantnet.core.types import ActQuant as JActQuant

    jaq = JActQuant(scale=jnp.float32(0.01), zero_point=jnp.int32(-7))
    ref = jax.jit(lambda layer, x: jlinear.linear(layer, x, activation="relu", out_quant=jaq))(jl, jnp.asarray(x))
    got = tlinear.linear(tl, torch.from_numpy(x), activation="relu",
                         out_quant=ActQuant(torch.tensor(0.01), torch.tensor(-7, dtype=torch.int32)))
    assert got.dtype == torch.int8
    assert np.abs(got.numpy().astype(np.int32) - np.asarray(ref, np.int32)).max() <= 1
