"""W4A8 in the port against the JAX package, on the CPU.

W4A8 (static.bake with weight_bits=4) keeps 4-bit weights inside the static
int8-activation path: dense layers get group-wise scales along K, so their
product splits per group (quantnet/ops/linear.py:228-253), which the port
runs as the int8 GEMM kernel's grouped-K mode; on a CPU tensor the wrapper
runs its plain version (ops/int8_matmul.py::int8_gemm_epilogue_plain). The
JAX functions run jitted without XLA's fusion pass (`jit_unfused`: the CPU
backend would contract the epilogue's multiply-add into an FMA, which
neither the TPU nor the kernel does), on the exact `xla` int8 backend.

Bounds: bit-equal everywhere. The grouped combine adds the groups' f32
terms in group order from 0, as XLA's reduce over the group axis does, and
every other step is the static INT8 epilogue that is bit-equal already
(tests/test_torch_epilogue.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.core.quantize import affine_qparams as j_affine_qparams
from quantnet.core.quantize import quantize_affine as j_quantize_affine
from quantnet.core.quantize import quantize_symmetric_grouped as j_quantize_grouped
from quantnet.core.types import ActQuant as JActQuant
from quantnet.models import convnet as jconvnet
from quantnet.ops import linear as jlinear
from quantnet.quantize import static as jstatic
from quantnet.quantize.common import weight_colsum as j_weight_colsum
from quantnet_torch import interop
from quantnet_torch.core.types import ActQuant, QTensor
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.ops import linear as tlinear
from quantnet_torch.ops.int8_matmul import Epilogue, int8_gemm_epilogue, int8_gemm_epilogue_plain
from quantnet_torch.quantize import common as tcommon
from quantnet_torch.quantize import static as tstatic
from test_torch_convnet import jit_unfused

IMAGE = 16  # fc1's K = (16 / 8)^2 * 256 = 1024: eight groups of 128
BATCH = 4


@pytest.fixture(autouse=True)
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def _grouped_layer(k, n, group, seed, bias=True):
    """A W4A8 dense layer made by the JAX package (grouped 4-bit weight, the
    input's frozen domain from its min / max, per-group colsums), the same
    layer carried over into the port, and the f32 input."""
    r = np.random.default_rng(seed)
    w = jnp.asarray((r.standard_normal((k, n)) * 0.1).astype(np.float32))
    x = (r.standard_normal((5, k)) * 1.5).astype(np.float32)
    qt = j_quantize_grouped(w, group_size=group, bits=4)
    scale, zp = j_affine_qparams(jnp.min(x), jnp.max(x))
    jl = {"w": qt, "aq": JActQuant(scale=scale, zero_point=zp), "wsum": j_weight_colsum(qt)}
    if bias:
        jl["b"] = jnp.asarray((r.standard_normal(n) * 0.3).astype(np.float32))
    tl = interop.from_jax_qparams({"l": jax.tree.map(np.asarray, jl)}, device="cpu")["l"]
    return jl, tl, x


def _out_quant():
    return (JActQuant(scale=jnp.float32(0.05), zero_point=jnp.int32(-100)),
            ActQuant(torch.tensor(0.05), torch.tensor(-100, dtype=torch.int32)))


@pytest.mark.parametrize("epilogue", ["plain", "relu_out_quant"])
@pytest.mark.parametrize("int8_input", [False, True])
@pytest.mark.parametrize("group", [32, 64, 128])
def test_grouped_static_linear_matches_jax(group, int8_input, epilogue):
    """The grouped static linear, bit for bit: f32 input quantized here, or
    int8 input already in the layer's domain (the handoff); f32 output, or
    relu and an int8 store in the consumer's domain (tests/test_w4a8.py:37-114)."""
    jl, tl, x = _grouped_layer(256, 24, group, seed=group + 7 * int8_input)
    assert tl["gemm"].group == group and tl["gemm"].zpw.shape == (256 // group, 24)
    if int8_input:
        x = np.array(j_quantize_affine(jnp.asarray(x), jl["aq"].scale, jl["aq"].zero_point))
    jout, tout = _out_quant() if epilogue == "relu_out_quant" else (None, None)
    act = "relu" if epilogue == "relu_out_quant" else None
    ref = jit_unfused(lambda l, xx: jlinear.linear(l, xx, activation=act, out_quant=jout), jl,
                      jnp.asarray(x))
    got = tlinear.linear(tl, torch.from_numpy(x), activation=act, out_quant=tout)
    assert got.dtype == (torch.int8 if tout is not None else torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_grouped_colsum_shape_and_values():
    r = np.random.default_rng(3)
    w = (r.standard_normal((256, 10))).astype(np.float32)
    jq = j_quantize_grouped(jnp.asarray(w), group_size=64, bits=4)
    tq = tcommon.quantize_weight(torch.from_numpy(w), True, bits=4, group_size=64)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    ws = tcommon.weight_colsum(tq)
    assert ws.shape == (4, 10) and ws.dtype == torch.int32
    np.testing.assert_array_equal(ws.numpy(), np.asarray(j_weight_colsum(jq)))
    np.testing.assert_array_equal(ws.numpy(), tq.values.numpy().astype(np.int64).reshape(4, 64, 10).sum(1))


def test_grouped_plain_is_the_unfused_route():
    """The grouped mode's plain version against G separate int8 products
    and the combine written out, on odd shapes (K = 96, g = 32, N = 33): the
    function the kernel must match bit for bit on the card."""
    r = np.random.default_rng(4)
    a = torch.from_numpy(r.integers(-128, 128, (7, 96)).astype(np.int8))
    b = torch.from_numpy(r.integers(-7, 8, (33, 96)).astype(np.int8))
    gs = torch.from_numpy(r.random((3, 33)).astype(np.float32) * 1e-2)
    gz = torch.from_numpy(r.integers(-3000, 3000, (3, 33)).astype(np.int32))
    epi = Epilogue(cs=torch.full((33,), 0.03), bias=torch.ones(33), act="relu6", group=32, gs=gs,
                   gzpw=gz)
    y = torch.zeros((7, 33))
    for g in range(3):
        acc = (a[:, 32 * g:32 * g + 32].long() @ b[:, 32 * g:32 * g + 32].long().t()).int()
        y = y + (acc - gz[g]).float() * gs[g]
    want = torch.clamp(y * 0.03 + 1.0, 0.0, 6.0)
    got = int8_gemm_epilogue(a, b, epi)
    assert torch.equal(got, want) and torch.equal(got, int8_gemm_epilogue_plain(a, b, epi))
    with pytest.raises(ValueError, match="does not divide"):
        int8_gemm_epilogue(a[:, :80].contiguous(), b[:, :80].contiguous(), epi)
    with pytest.raises(ValueError, match="no zpw"):
        int8_gemm_epilogue(a, b, Epilogue(cs=epi.cs, zpw=gz[0], group=32, gs=gs, gzpw=gz))


@pytest.fixture(scope="module")
def convnet_w4a8():
    """The convnet's W4A8 tree baked by the JAX package (g128 on the dense
    layers, per channel on the convs, int8 stem) from min-max statistics of
    one seeded batch, with the statistics and the folded params."""
    params, state = jconvnet.init(jax.random.PRNGKey(0), image_size=IMAGE)
    from quantnet.quantize.fold import fold_model_jit

    jf, _ = fold_model_jit(params, state)
    calib = np.random.default_rng(1).standard_normal((8, IMAGE, IMAGE, 3)).astype(np.float32)
    act = jstatic.calibrate(jconvnet.apply, jf, {}, [calib])
    jq, _ = jstatic.bake(jf, {}, act, weight_bits=4, weight_group_size=128)
    x = np.random.default_rng(2).standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    return {"jf": jf, "act": act, "jq": jq, "x": x}


def test_convnet_w4a8_forward_matches_jax(convnet_w4a8):
    m = convnet_w4a8
    ref = jit_unfused(lambda q, xx: jconvnet.apply(q, {}, xx)[0], m["jq"], jnp.asarray(m["x"]))
    tq = interop.from_jax_qparams(jax.tree.map(np.asarray, m["jq"]), device="cpu")
    fc1 = tq["fc1"]
    assert isinstance(fc1["w"], QTensor) and fc1["w"].group_size == 128 and fc1["w"].bits == 4
    assert fc1["wsum"].shape == (1024 // 128, 512) and tq["conv2"]["w"].group_size is None
    got, _ = tconvnet.apply(tq, {}, torch.from_numpy(m["x"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_w4a8_bake_matches_jax(convnet_w4a8):
    """The port's bake from the same folded params and statistics is the JAX
    package's, leaf for leaf (4-bit grouped and per-channel weights, their
    scales, the per-group colsums, the GEMM constants)."""
    m = convnet_w4a8
    tf = interop.from_jax_params(jax.tree.map(np.asarray, m["jf"]), {}, device="cpu")[0]
    act = {k: (torch.from_numpy(np.asarray(s)), torch.from_numpy(np.asarray(z)))
           for k, (s, z) in m["act"].items()}
    got, _ = tstatic.bake(tf, {}, act, weight_bits=4, weight_group_size=128)
    ref = interop.from_jax_qparams(jax.tree.map(np.asarray, m["jq"]), device="cpu")
    for name in ("conv1", "conv4", "fc1", "fc2"):
        a, b = got[name], ref[name]
        assert (a["w"].bits, a["w"].group_size) == (b["w"].bits, b["w"].group_size), name
        for t, u in ((a["w"].values, b["w"].values), (a["w"].scale, b["w"].scale),
                     (a["wsum"], b["wsum"]), (a["gemm"].zpw, b["gemm"].zpw),
                     (a["gemm"].w_scale, b["gemm"].w_scale), (a["gemm"].cs, b["gemm"].cs)):
            assert torch.equal(t, u), name
    assert got["fc2"]["w"].group_size == 128 and got["fc2"]["wsum"].shape == (4, 10)
    # An 'int8' policy entry keeps that layer's weight 8-bit, with no groups.
    kept, _ = tstatic.bake(tf, {}, act, weight_bits=4, weight_group_size=128,
                           layer_policy={"fc1": "int8"})
    assert (kept["fc1"]["w"].bits, kept["fc1"]["w"].group_size) == (8, None)
    with pytest.raises(ValueError, match="weight_bits"):
        tstatic.bake(tf, {}, act, weight_bits=5)
