"""quantnet_torch core numerics against the JAX package, bit for bit.

Inputs are made with numpy from a seed and go through both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import quantize as jq
from quantnet_torch.core import quantize as tq
from quantnet_torch.core.types import DynamicActQuant, QTensor

SHAPES = [(7, 33), (64, 1024), (2, 8, 8, 16)]
# The JAX package runs its forward under jit, where XLA takes amax / 127 as a
# multiply by f32(1 / 127); the port's runtime scale does the same.
jit_dynamic_quantize = jax.jit(jq.dynamic_quantize, static_argnames="axis")


def _x(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_quantize_per_tensor_bit_exact(shape, dtype):
    x = _x(shape, 0)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jv, js = jit_dynamic_quantize(jx, axis=None)
    tv, ts = tq.dynamic_quantize(tx, axis=None)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_quantize_per_row_bit_exact(shape, dtype):
    x = _x(shape, 1)
    x[0] = 0.0  # an all-zero row takes the EPS floor
    jv, js = jit_dynamic_quantize(jnp.asarray(x).astype(dtype), axis=0)
    tv, ts = tq.dynamic_quantize(torch.from_numpy(x).to(getattr(torch, dtype)), axis=0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tuple(ts.shape) == (shape[0], 1)


@pytest.mark.parametrize("shape,axis", [((3, 3, 16, 32), 3), ((256, 10), 1), ((64, 48), None)])
def test_quantize_symmetric_bit_exact(shape, axis):
    """Against the JAX function under jit, as the JAX package's weight bakes
    run it: XLA takes amax / 127 as a multiply by f32(1 / 127)."""
    w = _x(shape, 2, scale=0.05)
    jqt = jax.jit(jq.quantize_symmetric, static_argnames="axis")(jnp.asarray(w), axis=axis)
    tqt = tq.quantize_symmetric(torch.from_numpy(w), axis=axis)
    np.testing.assert_array_equal(tqt.values.numpy(), np.asarray(jqt.values))
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
    assert tqt.axis == jqt.axis and tqt.bits == jqt.bits
    np.testing.assert_array_equal(
        tqt.dequantize().numpy(), np.asarray(jqt.dequantize())
    )


def test_round_half_to_even_and_true_division():
    """Exact halves round to even, and x / scale is true division: a scale
    whose reciprocal is inexact must not change the quotient."""
    scale = np.float32(0.1)
    x = (np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32) * scale).astype(np.float32)
    jv = jq.quantize_affine(jnp.asarray(x), jnp.float32(scale), jnp.int32(0))
    tv = tq.quantize_affine(torch.from_numpy(x), torch.tensor(scale), torch.tensor(0))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # torch.round is half-to-even like jnp.round (C's roundf is not).
    np.testing.assert_array_equal(
        torch.round(torch.tensor([0.5, 1.5, 2.5, -2.5])).numpy(), [0.0, 2.0, 2.0, -2.0]
    )


@pytest.mark.parametrize("zp", [0, -17, 100])
def test_quantize_affine_and_dequantize_bit_exact(zp):
    x = _x((40, 24), 3)
    scale = np.float32(0.037)
    jv = jq.quantize_affine(jnp.asarray(x), jnp.float32(scale), jnp.int32(zp))
    tv = tq.quantize_affine(torch.from_numpy(x), torch.tensor(scale), torch.tensor(zp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jd = jq.dequantize(jv, jnp.float32(scale), jnp.int32(zp))
    td = tq.dequantize(tv, torch.tensor(scale), torch.tensor(zp))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_symmetric_scale_floors_at_eps():
    z = np.zeros((4, 5), np.float32)
    np.testing.assert_array_equal(
        tq.symmetric_scale(torch.from_numpy(z)).numpy(),
        np.asarray(jax.jit(jq.symmetric_scale)(jnp.asarray(z))),
    )
    assert tq.EPS == jq.EPS and tq.SYM_MAX == jq.SYM_MAX
    assert tq.sym_max(8) == jq.sym_max(8) == 127.0 and tq.sym_max(4) == 7.0


def test_qtensor_nk_operand():
    w = torch.arange(2 * 3 * 4 * 5, dtype=torch.int8).reshape(2, 3, 4, 5)
    qt = QTensor(values=w, scale=torch.ones(1, 1, 1, 5))
    nk = qt.nk()
    assert tuple(nk.shape) == (5, 24) and nk.is_contiguous()
    np.testing.assert_array_equal(nk.numpy(), w.reshape(24, 5).t().numpy())
    assert qt.nk() is nk  # made once


def test_dynamic_act_quant_handoff_dtype():
    assert DynamicActQuant("bfloat16").handoff_dtype == torch.bfloat16
    assert DynamicActQuant().handoff_dtype is None
    assert DynamicActQuant("bfloat16") == DynamicActQuant("bfloat16")
