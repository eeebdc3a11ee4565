"""The port's fp32 / bf16 products against the JAX package's: bf16 operands,
f32 accumulation and an f32 result (`preferred_element_type=f32`,
quantnet/ops/linear.py:164-168, quantnet/ops/conv.py:233-237).

A layer with bf16 weights pulls an f32 input down to bf16; a bf16 input (the
dynamic scheme's handoff) into an f32 layer multiplies in bf16 too. Either
way the product must not be rounded to bf16 before it is widened. Bound:
f32 summation order, rtol 1e-5 with atol 1e-5 x max|y| (a product rounded
to bf16 misses it by three orders of magnitude).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.ops import conv as jconv
from quantnet.ops import linear as jlinear
from quantnet.quantize import bf16 as jbf16
from quantnet_torch import interop
from quantnet_torch.ops import conv as tconv
from quantnet_torch.ops import linear as tlinear
from quantnet_torch.quantize import bf16 as tbf16


def _layer(w_shape, seed, w_dtype):
    r = np.random.default_rng(seed)
    fan_in = int(np.prod(w_shape[:-1]))
    w = (r.standard_normal(w_shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    b = (r.standard_normal(w_shape[-1]) * 0.1).astype(np.float32)
    jl = {"w": jnp.asarray(w).astype(w_dtype), "b": jnp.asarray(b).astype(w_dtype)}
    return jl, interop.from_jax_qparams(jax.tree.map(np.asarray, jl), device="cpu")


def _input(shape, seed, x_dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# (weight dtype, input dtype): bf16 weights on an f32 input (the bf16 scheme,
# the optimized policy's bf16 islands), and an f32 layer fed the bf16 handoff
# (fc2 under dynamic INT8 with skip_last_layer).
DTYPES = [("bfloat16", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("w_dtype,x_dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(64, 4096, 512), (5, 512, 10)])
def test_linear_accumulates_in_f32(w_dtype, x_dtype, m, k, n):
    jl, tl = _layer((k, n), k + n, w_dtype)
    jx, tx = _input((m, k), m, x_dtype)
    ref = jax.jit(lambda layer, x: jlinear.linear(layer, x, activation="relu"))(jl, jx)
    _close(tlinear.linear(tl, tx, activation="relu"), ref)


@pytest.mark.parametrize("w_dtype,x_dtype", DTYPES)
@pytest.mark.parametrize("shape,cin,cout", [((2, 16, 16), 64, 128), ((2, 9, 7), 3, 64)])
def test_conv_accumulates_in_f32(w_dtype, x_dtype, shape, cin, cout):
    jl, tl = _layer((3, 3, cin, cout), cin + cout, w_dtype)
    jx, tx = _input(shape + (cin,), cin, x_dtype)
    ref = jax.jit(lambda layer, x: jconv.conv2d(layer, x, activation="relu"))(jl, jx)
    _close(tconv.conv2d(tl, tx, activation="relu"), ref)


def test_bf16_transform_matches_jax():
    """bf16.quantize: fold, then every f32 tensor to bf16, bit for bit the
    jitted JAX transform's on the JAX-folded tree."""
    from quantnet.models import convnet as jconvnet
    from quantnet.quantize import fold as jfold

    params, state = jconvnet.init(jax.random.PRNGKey(0), image_size=16)
    folded, _ = jfold.fold_model_jit(params, state)
    ref, _ = jbf16.quantize(folded, {})
    got, got_state = tbf16.quantize(
        interop.from_jax_params(jax.tree.map(np.asarray, folded), {}, device="cpu")[0], {}
    )
    assert got_state == {}
    for name, layer in ref.items():
        assert set(got[name]) == set(layer), name
        for key, leaf in layer.items():
            assert got[name][key].dtype == torch.bfloat16, (name, key)
            np.testing.assert_array_equal(
                got[name][key].float().numpy(), np.asarray(leaf.astype(jnp.float32)), err_msg=name
            )
