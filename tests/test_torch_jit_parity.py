"""The port against the JAX package as the JAX package really runs: under jit.

Every real JAX path (the bench, the evaluator, serving) runs jitted, and XLA
then takes the runtime activation scale's `amax / 127` as a multiply by
f32(1 / 127); eager JAX divides. The port computes the jitted form
(quantnet_torch/core/quantize.py). XLA's CPU backend also contracts a
multiply and an add inside one fusion into an FMA, which the TPU and the
port's kernels do not do, so the bit-exact references here are compiled
without XLA's fusion pass (`jit_unfused`), and the plain jit is held to float
order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from quantnet.core import quantize as jq
from quantnet.models import convnet as jconvnet
from quantnet.ops.pallas_matmul import dynamic_int8_matmul_fused
from quantnet_torch.core import quantize as tq
from quantnet_torch.core.config import Flags
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm_plain
from test_torch_convnet import _use_backends, jit_unfused, model  # noqa: F401 (fixture)

jit_scale = jax.jit(jq.symmetric_scale, static_argnames="axis")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_scale_is_the_jitted_one(dtype):
    """4096x512, seed 0, per row: eager JAX divides and parts from the jitted
    scale in 204 rows of the f32 input; the port is bit-equal to the jit."""
    x = np.random.default_rng(0).standard_normal((4096, 512)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = np.asarray(jit_scale(jx, axis=0))
    _, got = tq.dynamic_quantize(tx, axis=0)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tq.symmetric_scale(tx, axis=0).numpy(), ref)
    eager_differs = int((np.asarray(jq.symmetric_scale(jx, axis=0)) != ref).sum())
    assert eager_differs > 0
    if dtype == "float32":
        assert eager_differs == 204
    # Per tensor, as the convs take it.
    np.testing.assert_array_equal(
        tq.dynamic_quantize(tx, axis=None)[1].numpy(), np.asarray(jax.jit(jq.symmetric_scale)(jx))
    )


@pytest.mark.parametrize("matmul,conv,linear", [("pallas", "im2col", "fused"), ("xla", "xla", "unfused")])
def test_dynamic_convnet_logits_equal_jit(monkeypatch, model, matmul, conv, linear):  # noqa: F811
    """The dynamic convnet at the test size: bit-equal logits to
    jax.jit(convnet.apply) without the fusion pass, and within float order of
    the plain jit (its FMAs)."""
    _use_backends(monkeypatch, matmul, conv)

    def forward(q, qs, x):
        return jconvnet.apply(q, qs, x)[0]

    args = (model["jq"], model["jqs"], jnp.asarray(model["x"]))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.block_until_ready(jit_unfused(forward, *args)))
        fused = np.asarray(jax.block_until_ready(jax.jit(forward)(*args)))
    got, _ = tconvnet.apply(model["tq"], {}, torch.from_numpy(model["x"]),
                            flags=Flags(dynamic_linear=linear))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(got.numpy(), fused, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(8, 4096, 512), (16, 600, 10), (5, 128, 130)])
def test_fused_plain_equals_jitted_pallas(m, k, n, dtype):
    """K2's plain version against the interpret-mode Pallas kernel, jitted as
    it always is: its block scale multiplies by f32(1 / 127) too. The result
    is waited on (an eager interpret-mode kernel can deadlock the CPU run)."""
    r = np.random.default_rng(m + k + n)
    x = (r.standard_normal((m, k)) * 2.0).astype(np.float32)
    qw = r.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (r.random(n) * 1e-2 + 1e-4).astype(np.float32)
    b = r.standard_normal(n).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jargs = (jx, jnp.asarray(qw), jnp.asarray(ws), jnp.asarray(b))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.block_until_ready(jit_unfused(dynamic_int8_matmul_fused, *jargs)))
        fused = np.asarray(jax.block_until_ready(dynamic_int8_matmul_fused(*jargs)))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = fused_dynamic_gemm_plain(
        tx, torch.from_numpy(qw.T.copy()), torch.from_numpy(ws), torch.from_numpy(b)
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, fused, rtol=1e-5, atol=1e-4)
