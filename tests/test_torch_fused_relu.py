"""K2 with the layer's relu fused into its store, against the JAX package.

The convnet's fc1 is a dynamic dense layer with a relu. The port's fused
branch hands the relu to K2 (`fused_dynamic_gemm(..., relu=True)`), and the
JAX package applies it after `dynamic_int8_matmul_fused`
(quantnet/ops/linear.py:202-213). Both are held here bit for bit: the JAX
linear on the Pallas backend, the kernel in interpret mode, jitted and
compiled without XLA's fusion pass (`jit_unfused`: XLA's CPU backend would
contract the epilogue's multiply-add into an FMA, which neither the TPU nor
the port does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from quantnet.ops import linear as jlinear
from quantnet_torch.core.config import Flags
from quantnet_torch.ops import linear as tlinear
from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm, fused_dynamic_gemm_plain
from test_torch_convnet import _use_backends, jit_unfused
from test_torch_ops import _dynamic_layer

# fc1 at the serving batch (bs32: 32 x 4096 x 512, the bf16 handoff of conv6)
# and a ragged shape off every block step (two K-blocks, the second 88 wide).
SHAPES = [(32, 4096, 512, "bfloat16"), (5, 600, 10, "float32")]


@pytest.mark.parametrize("m,k,n,dtype", SHAPES)
def test_fused_relu_equals_jax_linear(monkeypatch, m, k, n, dtype):
    _use_backends(monkeypatch, "pallas", "im2col")
    jlayer, tlayer = _dynamic_layer((k, n), m + k + n)
    x = (np.random.default_rng(k).standard_normal((m, k)) * 2.0).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    def forward(layer, xx):
        return jlinear.linear(layer, xx, activation="relu")

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.block_until_ready(jit_unfused(forward, jlayer, jx)))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    g = tlayer["gemm"]
    got = fused_dynamic_gemm_plain(tx, g.w_nk, g.w_scale, g.bias, relu=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 0).any() and (ref > 0).any()
    # The ops layer's fused branch: the relu goes into K2, nothing after it.
    via_linear = tlinear.linear(tlayer, tx, activation="relu", flags=Flags(dynamic_linear="fused"))
    assert via_linear.dtype == torch.float32
    np.testing.assert_array_equal(via_linear.numpy(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_flag_is_torch_relu_of_the_unfused_store(dtype):
    """relu=True gives torch.relu of the relu=False result, bit for bit, and
    the CPU wrapper runs the plain version without a launch."""
    r = np.random.default_rng(3)
    x = torch.from_numpy((r.standard_normal((9, 700)) * 3).astype(np.float32)).to(dtype)
    w = torch.from_numpy(r.integers(-127, 128, (12, 700)).astype(np.int8))
    ws = torch.from_numpy((r.random(12) * 1e-2 + 1e-4).astype(np.float32))
    b = torch.from_numpy(r.standard_normal(12).astype(np.float32))
    fused_dynamic_gemm.launches = 0
    plain = fused_dynamic_gemm(x, w, ws, b)
    got = fused_dynamic_gemm(x, w, ws, b, relu=True)
    assert fused_dynamic_gemm.launches == 0
    assert torch.equal(got.view(torch.int32), torch.relu(plain).view(torch.int32))
    assert (plain < 0).any()
