"""The sensitivity probe's lanes and the `__specs__` capture, against the JAX package.

The probe: a float layer that carries a ProbeGate runs its plain lane
(gate 0) or its quantized lane (gate 1), built as the JAX package builds it
(quantnet/ops/conv.py:171-195, linear.py:109-127). The JAX branch runs
jitted without XLA's fusion pass (`jit_unfused`) with its `xla` int8
backends; the port's dense layers take the matching `dynamic_linear`
("unfused"; "fused" against the Pallas kernel in interpret mode). Inputs
and weights are dyadic (x a multiple of 1/8, w of 1/16, every weight group
reaching +-7/16), so every f32 product and sum of the float lanes is exact
whatever order the two frameworks' convs and products sum in, and the
4-bit group scales are exactly 1/16: every case is held bit for bit.

`__specs__`: with the side channel seeded, each model records the same
(kind, stride, padding, activation) 4-tuples as the JAX package, for the
small convnet, ResNet-18 and MobileNetV2 0.25, with XLA's SAME and with
torch's explicit pads; calibration's capture (no seed) holds tensors only.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from quantnet.core import config as jcfg
from quantnet.core.types import ProbeGate as JProbeGate
from quantnet.models import convnet as jconvnet
from quantnet.models import mobilenet as jmobilenet
from quantnet.models import resnet as jresnet
from quantnet.ops.conv import conv2d as jconv2d
from quantnet.ops.linear import linear as jlinear
from quantnet_torch.core.config import Flags
from quantnet_torch.core.types import ProbeGate
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.models import mobilenet as tmobilenet
from quantnet_torch.models import resnet as tresnet
from quantnet_torch.ops.conv import conv2d as tconv2d
from quantnet_torch.ops.linear import linear as tlinear
from quantnet_torch.quantize import fold as tfold
from test_torch_convnet import jit_unfused

GATES = [0.0, 1.0]
ACT_QUANT = [True, False]
BITS = [(8, None), (4, 128)]


@pytest.fixture(autouse=True)
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def _dyadic_weight(shape, seed, group_rows):
    """Multiples of 1/16 in [-7/16, 7/16]; every group of `group_rows` rows
    of every output channel holds +-7/16, so a 4-bit group scale is exactly
    1/16 (7/16 * f32(1/7) rounds to it)."""
    r = np.random.default_rng(seed)
    w = r.integers(-6, 7, size=shape).astype(np.float32) / 16
    flat = w.reshape(-1, shape[-1])
    for g0 in range(0, flat.shape[0], group_rows):
        flat[g0, :] = np.where(r.random(shape[-1]) < 0.5, -7, 7) / 16
    return flat.reshape(shape)


def _dyadic_x(shape, seed):
    return np.random.default_rng(seed).integers(-16, 17, size=shape).astype(np.float32) / 8


def _jax_probe(op, layer, x, gate, probe_kw, **kw):
    def fn(layer, x, gate):
        return op(dict(layer, probe=JProbeGate(gate=gate, **probe_kw)), x, **kw)

    return np.asarray(jit_unfused(fn, jax.tree.map(jnp.asarray, layer), jnp.asarray(x),
                                  jnp.float32(gate)))


def _port_probe(op, layer, x, gate, probe_kw, **kw):
    tl = {k: torch.from_numpy(v) for k, v in layer.items()}
    tl["probe"] = ProbeGate(gate=gate, **probe_kw)
    return op(tl, torch.from_numpy(x), **kw)


CONVS = {
    # (x shape, w shape, stride, activation, groups)
    "dense": ((2, 8, 8, 16), (3, 3, 16, 24), 1, "relu", 1),
    "depthwise": ((2, 9, 9, 24), (3, 3, 1, 24), 2, "relu6", 24),
}


@pytest.mark.parametrize("bits,group_size", BITS)
@pytest.mark.parametrize("act_quant", ACT_QUANT)
@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("kind", list(CONVS))
def test_conv_probe_lane_bit_equal(kind, gate, act_quant, bits, group_size):
    xs, ws, stride, act, groups = CONVS[kind]
    layer = {"w": _dyadic_weight(ws, 1, 9), "b": _dyadic_x((ws[-1],), 2) / 8}
    x = _dyadic_x(xs, 3)
    probe_kw = dict(per_channel=True, bits=bits, group_size=group_size, act_quant=act_quant)
    kw = dict(stride=stride, padding="SAME", activation=act, groups=groups)
    ref = _jax_probe(jconv2d, layer, x, gate, probe_kw, **kw)
    got = _port_probe(tconv2d, layer, x, gate, probe_kw, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bits,group_size", BITS)
@pytest.mark.parametrize("act_quant", ACT_QUANT)
@pytest.mark.parametrize("gate", GATES)
def test_linear_probe_lane_bit_equal(gate, act_quant, bits, group_size):
    layer = {"w": _dyadic_weight((256, 24), 4, 128), "b": _dyadic_x((24,), 5) / 8}
    x = _dyadic_x((4, 256), 6)
    probe_kw = dict(per_channel=True, bits=bits, group_size=group_size, act_quant=act_quant)
    if act_quant and group_size is not None:
        # A grouped weight has no dynamic kernel: both packages refuse the
        # lane (the JAX package at trace time, whatever the gate; the port
        # when the gate picks it).
        with pytest.raises(NotImplementedError):
            _jax_probe(jlinear, layer, x, gate, probe_kw, activation="relu")
        if gate:
            with pytest.raises(NotImplementedError):
                _port_probe(tlinear, layer, x, gate, probe_kw, activation="relu",
                            flags=Flags(dynamic_linear="unfused"))
        return
    ref = _jax_probe(jlinear, layer, x, gate, probe_kw, activation="relu")
    got = _port_probe(tlinear, layer, x, gate, probe_kw, activation="relu",
                      flags=Flags(dynamic_linear="unfused"))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_linear_probe_fused_lane_matches_pallas(monkeypatch):
    """The dynamic dense lane through the fused kernel's plain version, held
    against the JAX package's Pallas kernel in interpret mode."""
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "pallas")
    layer = {"w": _dyadic_weight((512, 24), 7, 128), "b": _dyadic_x((24,), 8) / 8}
    x = np.random.default_rng(9).standard_normal((8, 512)).astype(np.float32)
    probe_kw = dict(per_channel=True, bits=8, group_size=None, act_quant=True)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.block_until_ready(_jax_probe(jlinear, layer, x, 1.0, probe_kw, activation="relu"))
    got = _port_probe(tlinear, layer, x, 1.0, probe_kw, activation="relu", flags=Flags())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_probe_requantizes_into_out_quant():
    """out_quant applies after the picked lane (maybe_requantize)."""
    from quantnet_torch.core.types import ActQuant

    layer = {"w": _dyadic_weight((3, 3, 16, 24), 1, 9), "b": _dyadic_x((24,), 2) / 8}
    x = _dyadic_x((2, 8, 8, 16), 3)
    oq = ActQuant(scale=torch.tensor(0.05), zero_point=torch.tensor(-3, dtype=torch.int32))
    kw = dict(per_channel=True, bits=8, group_size=None, act_quant=True)
    tl = {k: torch.from_numpy(v) for k, v in layer.items()}
    y = tconv2d(dict(tl, probe=ProbeGate(gate=1.0, **kw)), torch.from_numpy(x), activation="relu")
    q = tconv2d(dict(tl, probe=ProbeGate(gate=1.0, **kw)), torch.from_numpy(x), activation="relu",
                out_quant=oq)
    assert q.dtype == torch.int8
    from quantnet_torch.core.quantize import quantize_affine

    assert torch.equal(q, quantize_affine(y, oq.scale, oq.zero_point))


def _specs(jax_apply, port_apply, params, state, size):
    """Both packages' specs on the same BN-folded tree (the port's seeded
    init and fold; the trees have the same layout): the JAX package's
    traced with jax.eval_shape, as its accuracy tools take them."""
    fp, fs = tfold.fold_model(params, state)
    x = np.random.default_rng(0).standard_normal((1, size, size, 3)).astype(np.float32)
    jfp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), fp)
    jcap = {"__specs__": {}}
    jax.eval_shape(lambda p, xx: jax_apply(p, {}, xx, capture=jcap)[0], jfp, jnp.asarray(x))
    cap = {"__specs__": {}}
    port_apply(fp, fs, torch.from_numpy(x), capture=cap)
    assert all(isinstance(v, torch.Tensor) for k, v in cap.items() if k != "__specs__")
    return cap["__specs__"], jcap["__specs__"]


def test_convnet_specs_match_jax():
    got, ref = _specs(jconvnet.apply, tconvnet.apply, *tconvnet.init(image_size=16, device="cpu"), 16)
    assert got == ref and len(got) == 8


@pytest.mark.parametrize("torch_pad", [False, True])
def test_resnet18_specs_match_jax(torch_pad):
    got, ref = _specs(functools.partial(jresnet.apply, torch_pad=torch_pad),
                      functools.partial(tresnet.apply, torch_pad=torch_pad),
                      *tresnet.init(depth=18, num_classes=10, device="cpu"), 32)
    assert got == ref and len(got) == 21
    assert got["layer2/0/conv1"][2] == (((1, 1), (1, 1)) if torch_pad else "SAME")


@pytest.mark.parametrize("torch_pad", [False, True])
def test_mobilenet_specs_match_jax(torch_pad):
    got, ref = _specs(functools.partial(jmobilenet.apply, torch_pad=torch_pad),
                      functools.partial(tmobilenet.apply, torch_pad=torch_pad),
                      *tmobilenet.init(num_classes=10, width_mult=0.25, device="cpu"), 32)
    assert got == ref and len(got) == 53
    assert got["block1/dw"][0] == "dwconv" and got["fc"] == ("linear", None, None, None)


def test_calibration_capture_holds_tensors_only():
    fp, fs = tfold.fold_model(*tconvnet.init(image_size=16, device="cpu"))
    cap = {}
    tconvnet.apply(fp, fs, torch.zeros((1, 16, 16, 3)), capture=cap)
    assert "__specs__" not in cap and all(isinstance(v, torch.Tensor) for v in cap.values())
