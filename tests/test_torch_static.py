"""quantnet_torch's static-INT8 pieces against the JAX package's: affine
qparams, observers, the static conv and linear branches with the int8
handoff, the residual boundary (K3's plain version against the Pallas kernel
in interpret mode), and calibrate + bake.

The JAX int8 paths run on the exact `xla` backend (set with monkeypatch):
the CPU default, `emulate`, is exact only while |acc| < 2**24
(quantnet/ops/linear.py:45-49). Integer work and the f32 epilogues are then
the same bits on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from quantnet.core import config as jcfg
from quantnet.core import observers as jobservers
from quantnet.core.quantize import affine_qparams as j_affine_qparams
from quantnet.core.quantize import quantize_symmetric as j_quantize_symmetric
from quantnet.core.types import ActQuant as JActQuant
from quantnet.ops import conv as jconv
from quantnet.ops import linear as jlinear
from quantnet.ops.pallas_boundary import residual_boundary as j_residual_boundary
from quantnet.quantize.common import weight_colsum as j_weight_colsum
from quantnet_torch import interop
from quantnet_torch.core import observers as tobservers
from quantnet_torch.core.quantize import affine_qparams, maybe_requantize
from quantnet_torch.core.types import ActQuant
from quantnet_torch.ops import conv as tconv
from quantnet_torch.ops import linear as tlinear
from quantnet_torch.ops.residual_boundary import residual_boundary, residual_boundary_plain
from quantnet_torch.quantize.common import resolve_policy, weight_colsum


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def _min_max(n, seed):
    r = _rng(seed)
    lo = (-np.abs(r.standard_normal(n)) * r.random(n) * 10).astype(np.float32)
    hi = (np.abs(r.standard_normal(n)) * r.random(n) * 10).astype(np.float32)
    lo[:5] = [0.0, 1.5, -2.0, -np.inf, 0.0]  # ranges that do not hold 0, and an empty one
    hi[:5] = [0.0, 3.0, -1.0, np.inf, 0.0]
    lo[3], hi[3] = np.inf, -np.inf
    return lo, hi


@pytest.mark.parametrize("seed", [0, 1])
def test_affine_qparams_bit_exact(seed):
    """Against the JAX function under jit, where XLA multiplies by f32(1/255):
    calibration extracts qparams that way (static.py:100). 100k ranges."""
    lo, hi = _min_max(100_000, seed)
    js, jz = jax.jit(jax.vmap(j_affine_qparams))(jnp.asarray(lo), jnp.asarray(hi))
    ts, tz = affine_qparams(torch.from_numpy(lo), torch.from_numpy(hi))
    assert ts.dtype == torch.float32 and tz.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


@pytest.mark.parametrize("kind", ["minmax", "moving_average"])
def test_observers_match_jax(kind):
    """Three batches through each observer; qparams taken as calibrate takes
    them (jitted in JAX). Min-max is exact; the moving average's
    m * a + (1 - m) * b may be contracted into an FMA by XLA, so its range
    agrees to an ulp and its qparams to float order."""
    batches = [(_rng(i).standard_normal((4, 8)) * (i + 1)).astype(np.float32) for i in range(3)]
    jo = jobservers.make_observer(kind)
    to = tobservers.make_observer(kind)
    step = jax.jit(lambda o, x: o.update(x))
    for b in batches:
        jo = step(jo, jnp.asarray(b))
        to.update(torch.from_numpy(b))
    js, jz = jax.jit(lambda o: o.qparams())(jo)
    ts, tz = to.qparams()
    if kind == "minmax":
        assert float(ts) == float(js) and int(tz) == int(jz)
    else:
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
        assert abs(int(tz) - int(jz)) <= 1


def test_unported_observers_raise():
    for kind in ("histogram", "mse"):
        with pytest.raises(NotImplementedError):
            tobservers.make_observer(kind)
    with pytest.raises(ValueError):
        tobservers.make_observer("nope")


def test_weight_colsum_and_policy_match_jax():
    w = (_rng(1).standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)
    jq = j_quantize_symmetric(jnp.asarray(w), axis=3)
    got = weight_colsum(interop.from_jax_qparams({"w": jax.tree.map(np.asarray, jq)}, device="cpu")["w"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_weight_colsum(jq)))
    policy = {"layer1/0/conv1": "fp32", "conv2": "int8"}
    assert resolve_policy("layer1/0/conv1", "static", policy) == "fp32"
    assert resolve_policy("layer3/1/conv2", "static", policy) == "int8"
    assert resolve_policy("fc", "static", policy) == "static"
    assert resolve_policy("fc", "static", None) == "static"


def _aq(scale, zp):
    return JActQuant(scale=jnp.float32(scale), zero_point=jnp.int32(zp))


def _static_layer(w_shape, seed, aq=(0.05, -20), bias=True):
    """A baked static layer, JAX-side and carried over to the port."""
    r = _rng(seed)
    w = (r.standard_normal(w_shape) * 0.1).astype(np.float32)
    qw = j_quantize_symmetric(jnp.asarray(w), axis=len(w_shape) - 1)
    jl = {"w": qw, "aq": _aq(*aq), "wsum": j_weight_colsum(qw)}
    if bias:
        jl["b"] = jnp.asarray((r.standard_normal(w_shape[-1]) * 0.1).astype(np.float32))
    return jl, interop.from_jax_qparams({"l": jax.tree.map(np.asarray, jl)}, device="cpu")["l"]


def _assert_same(got, ref):
    assert str(got.dtype).rsplit(".", 1)[-1] == str(ref.dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# (kernel, stride, padding, input H x W): SAME asymmetric at stride 2 on an
# even input ((0, 1) pads), torch_pad's explicit (1, 1), VALID, 1x1 stride 2
# (a downsample) and 3x3 stride 2 on an odd input.
CONV_CASES = [
    (3, 2, "SAME", (8, 8)),
    (3, 2, ((1, 1), (1, 1)), (8, 8)),
    (3, 1, "VALID", (7, 6)),
    (1, 2, "VALID", (8, 8)),
    (3, 2, "SAME", (7, 9)),
    (7, 2, ((3, 3), (3, 3)), (16, 16)),
]


@pytest.mark.parametrize("out_quant", [False, True])
@pytest.mark.parametrize("int8_input", [False, True])
@pytest.mark.parametrize("k,stride,padding,hw", CONV_CASES)
def test_static_conv2d_bit_exact(xla, k, stride, padding, hw, int8_input, out_quant):
    """Zero-point pre-pad, int8 conv, - zp * wsum, f32 epilogue, relu, and the
    int8 handoff when out_quant is given: the JAX package's bits, on an f32
    input it quantizes and on an int8 input already in its domain."""
    jl, tl = _static_layer((k, k, 6, 10), 20 + k)
    x = (_rng(21).standard_normal((2, *hw, 6)) * 2).astype(np.float32)
    if int8_input:
        x = _rng(22).integers(-128, 128, (2, *hw, 6)).astype(np.int8)
    joq = _aq(0.03, 7) if out_quant else None
    toq = interop.from_jax_qparams({"q": jax.tree.map(np.asarray, joq)}, device="cpu")["q"] if out_quant else None
    ref = jconv.conv2d(jl, jnp.asarray(x), stride=stride, padding=padding, activation="relu", out_quant=joq)
    got = tconv.conv2d(tl, torch.from_numpy(x), stride=stride, padding=padding, activation="relu",
                       out_quant=toq)
    _assert_same(got, ref)


@pytest.mark.parametrize("padding", ["SAME", ((1, 2), (0, 1))])
def test_fp32_conv2d_out_quant_matches(padding):
    """The fp32 branch with out_quant (a skip_first_layer stem handing int8 on):
    the f32 conv agrees to float order, so the int8 output may move by one
    step where a value sits on a rounding edge; none does here."""
    r = _rng(23)
    w = r.standard_normal((3, 3, 4, 8)).astype(np.float32)
    x = r.standard_normal((2, 9, 9, 4)).astype(np.float32)
    joq = _aq(0.05, -30)
    toq = ActQuant(torch.tensor(0.05), torch.tensor(-30, dtype=torch.int32))
    ref = jconv.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x), stride=2, padding=padding,
                       activation="relu", out_quant=joq)
    got = tconv.conv2d({"w": torch.from_numpy(w)}, torch.from_numpy(x), stride=2, padding=padding,
                       activation="relu", out_quant=toq)
    _assert_same(got, ref)


@pytest.mark.parametrize("out_quant", [False, True])
@pytest.mark.parametrize("int8_input", [False, True])
def test_static_linear_bit_exact(xla, int8_input, out_quant):
    jl, tl = _static_layer((300, 24), 24, aq=(0.07, 12))
    x = (_rng(25).standard_normal((5, 300)) * 3).astype(np.float32)
    if int8_input:
        x = _rng(26).integers(-128, 128, (5, 300)).astype(np.int8)
    joq = _aq(0.2, -3) if out_quant else None
    toq = ActQuant(torch.tensor(np.float32(0.2)), torch.tensor(-3, dtype=torch.int32)) if out_quant else None
    ref = jlinear.linear(jl, jnp.asarray(x), activation="relu", out_quant=joq)
    got = tlinear.linear(tl, torch.from_numpy(x), activation="relu", out_quant=toq)
    _assert_same(got, ref)


def test_fp32_linear_out_quant_and_maybe_requantize():
    r = _rng(27)
    layer = {"w": r.standard_normal((16, 8)).astype(np.float32)}
    x = r.standard_normal((3, 16)).astype(np.float32)
    ref = jlinear.linear({"w": jnp.asarray(layer["w"])}, jnp.asarray(x), out_quant=_aq(0.1, 4))
    toq = ActQuant(torch.tensor(np.float32(0.1)), torch.tensor(4, dtype=torch.int32))
    got = tlinear.linear({"w": torch.from_numpy(layer["w"])}, torch.from_numpy(x), out_quant=toq)
    _assert_same(got, ref)
    y = torch.randn(4)
    assert maybe_requantize(y, None) is y


def _boundary_operands(shape, int8_id, seed):
    r = _rng(seed)
    out = (r.standard_normal(shape) * 3).astype(np.float32)
    if int8_id:
        ident = r.integers(-128, 128, shape).astype(np.int8)
    else:
        ident = r.standard_normal(shape).astype(np.float32)
    return out, ident


# The JAX package's test shapes (tests/test_pallas_kernels.py:117-136) and
# off-vector ones (C = 3 with an odd row count; 17 channels).
@pytest.mark.parametrize("shape,int8_id", [
    ((2, 9, 9, 256), True), ((4, 7, 7, 512), False),
    ((1, 7, 9, 3), True), ((1, 7, 9, 3), False), ((3, 5, 5, 17), True),
])
def test_residual_boundary_plain_matches_pallas_bit_exact(shape, int8_id):
    out, ident = _boundary_operands(shape, int8_id, sum(shape))
    j_id = (jnp.float32(0.043), jnp.int32(-5)) if int8_id else (None, None)
    with pltpu.force_tpu_interpret_mode():
        ref = j_residual_boundary(jnp.asarray(out), jnp.asarray(ident), *j_id, _aq(0.061, -128))
    id_q = ActQuant(torch.tensor(np.float32(0.043)), torch.tensor(-5, dtype=torch.int32)) if int8_id else None
    out_q = ActQuant(torch.tensor(np.float32(0.061)), torch.tensor(-128, dtype=torch.int32))
    residual_boundary.launches = 0
    got = residual_boundary(torch.from_numpy(out), torch.from_numpy(ident), id_q, out_q)
    assert residual_boundary.launches == 0  # a CPU tensor takes the plain version
    assert got.dtype == torch.int8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        residual_boundary_plain(torch.from_numpy(out), torch.from_numpy(ident), id_q, out_q).numpy(),
        np.asarray(ref))


def test_residual_boundary_rejects_bad_operands():
    out = torch.zeros((2, 3, 3, 4))
    q = ActQuant(torch.tensor(0.1), torch.tensor(0, dtype=torch.int32))
    with pytest.raises(TypeError):
        residual_boundary(out.double(), out, None, q)
    with pytest.raises(ValueError):
        residual_boundary(out, torch.zeros((2, 3, 3, 5)), None, q)
    with pytest.raises(ValueError):
        residual_boundary(out, out.to(torch.int8), None, q)


def test_actquant_host_scalars_are_kept():
    q = ActQuant(torch.tensor(np.float32(0.061)), torch.tensor(-128, dtype=torch.int32))
    assert q.host_scalars() == (float(np.float32(0.061)), -128.0)
    q.scale = torch.tensor(1.0)  # frozen parameters: the first read is kept
    assert q.host_scalars()[0] == float(np.float32(0.061))
