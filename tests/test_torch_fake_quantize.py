"""`fake_quantize_symmetric` and `fake_quantize_affine` against the JAX
helpers (quantnet/core/quantize.py:149-164), from the same numpy inputs.

Under jax.jit the two are bit-equal in every case. Eager JAX divides the
symmetric scale's absmax by 127, where jit multiplies by f32(1 / 127) and the
port computes the jitted form (quantnet_torch/core/quantize.py; the same as
tests/test_torch_jit_parity.py holds for the dynamic scale): eager, the
symmetric helper is bit-equal on every channel whose eager scale is the
jitted one, and the channels where eager JAX's division gives another scale
are counted. The affine helper takes its scale as an input, so eager and
jitted JAX agree and the port is bit-equal to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import quantize as jq
from quantnet_torch.core import quantize as tq

jit_symmetric = jax.jit(jq.fake_quantize_symmetric, static_argnames="axis")
jit_affine = jax.jit(jq.fake_quantize_affine)


def _x(shape, seed, zero=False):
    if zero:
        return np.zeros(shape, np.float32)
    return (np.random.default_rng(seed).standard_normal(shape) * 3.0).astype(np.float32)


# (shape, axis, all-zero input, scales where eager JAX's division is not
# the jitted multiply). An all-zero input takes the EPS floor's scale, which
# eager JAX divides to another value, and fake-quantizes to zeros either way.
SYMMETRIC = [
    ((64, 48), None, False, 0),
    ((64, 48), 0, False, 5),
    ((64, 48), 1, False, 1),
    ((3, 3, 16, 32), -1, False, 0),
    ((64, 48), None, True, 1),
    ((64, 48), 0, True, 64),
    ((64, 48), 1, True, 48),
]


@pytest.mark.parametrize("shape,axis,zero,eager_scales_differ", SYMMETRIC)
def test_fake_quantize_symmetric(shape, axis, zero, eager_scales_differ):
    x = _x(shape, len(shape) + (axis or 0) + 7, zero)
    got = tq.fake_quantize_symmetric(torch.from_numpy(x), axis)
    assert got.dtype == torch.float32 and got.device == torch.device("cpu")
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(jit_symmetric(jnp.asarray(x), axis=axis)))

    # Eager: bit-equal wherever eager JAX's scale is the jitted one.
    eager = np.asarray(jq.fake_quantize_symmetric(jnp.asarray(x), axis))
    e_scale = np.asarray(jq.symmetric_scale(jnp.asarray(x), axis))
    j_scale = np.asarray(jax.jit(jq.symmetric_scale, static_argnames="axis")(jnp.asarray(x), axis=axis))
    differ = np.broadcast_to(e_scale != j_scale, x.shape)
    np.testing.assert_array_equal(got[~differ], eager[~differ])
    assert int((e_scale != j_scale).sum()) == eager_scales_differ
    if zero:
        np.testing.assert_array_equal(got, np.zeros_like(x))


def test_symmetric_takes_bf16_input_and_returns_f32():
    x = _x((32, 16), 5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tq.fake_quantize_symmetric(xb, 1)
    assert got.dtype == torch.float32
    ref = jit_symmetric(jnp.asarray(x).astype(jnp.bfloat16), axis=1)
    assert ref.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _affine_params(kind, n, seed):
    r = np.random.default_rng(seed)
    if kind == "scalar":
        return np.float32(0.05), np.int32(-7)
    scale = (r.random((1, n)) * 0.1 + 1e-3).astype(np.float32)
    zp = r.integers(-128, 128, (1, n)).astype(np.int32)
    return scale, zp


@pytest.mark.parametrize("kind", ["scalar", "per_channel"])
@pytest.mark.parametrize("mode", ["eager", "jit"])
def test_fake_quantize_affine(kind, mode):
    """Values past both ends of the int8 range are clipped; a column sits at
    half steps, where rounding goes to even."""
    x = _x((96, 40), 11) * 2.0
    scale, zp = _affine_params(kind, 40, 12)
    # A column at half steps: (k + 0.5) * scale.
    x[:, 0] = ((np.arange(96) - 48) + 0.5).astype(np.float32) * np.float32(np.ravel(scale)[0])
    fn = jit_affine if mode == "jit" else jq.fake_quantize_affine
    ref = np.asarray(fn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(zp)))
    got = tq.fake_quantize_affine(torch.from_numpy(x), torch.from_numpy(np.asarray(scale)),
                                  torch.from_numpy(np.asarray(zp)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # Both ends of the range are reached.
    q = np.round(x / scale) + zp
    assert (q < -128).any() and (q > 127).any()


def test_affine_takes_python_numbers():
    x = _x((16, 8), 3)
    got = tq.fake_quantize_affine(torch.from_numpy(x), 0.02, 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jit_affine(jnp.asarray(x), 0.02, 5)))
