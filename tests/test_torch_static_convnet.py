"""The port's static-INT8 SimpleConvNet (the convnet's static sibling with
its int8 handoff) against the JAX package's.

Full widths at 16x16, batch 2 (fc1 K = 1024). Weights come from the JAX
package's init with non-trivial BN statistics, folded by the JAX package and
calibrated (min-max, one seeded batch of 4). The JAX int8 paths run on the
exact `xla` backend, jitted without XLA's fusion pass (`jit_unfused`).

Bounds. Given the JAX package's activation qparams the bake is the same
bits. Calibration: zero points equal, scales within 4e-6 relative (fp32
convs sum in other orders; ROADMAP Queue 3). Forward: with an int8 stem
every int8 tensor a layer receives is the same bits and so are the logits;
with the fp32 stem, conv1's f32 conv sums in another order than XLA's, so a
value at a rounding tie may requantize one step apart in conv2's domain
(none at this seed: the logits measured equal), and the logits are held
within 1e-3 x max|logit|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.models import convnet as jconvnet
from quantnet.quantize import fold as jfold
from quantnet.quantize import static as jstatic
from quantnet_torch import interop
from quantnet_torch.core.config import Flags
from quantnet_torch.core.types import ActQuant, QTensor
from quantnet_torch.entry import static_entry
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.ops.int8_matmul import int8_gemm
from quantnet_torch.quantize import static as tstatic
from test_torch_convnet import jit_unfused
from test_torch_resnet import _assert_trees_equal

IMAGE = 16
BATCH = 2


@pytest.fixture(scope="module")
def model():
    params, state = jconvnet.init(jax.random.PRNGKey(0), image_size=IMAGE)
    pn, sn = jax.tree.map(np.array, params), jax.tree.map(np.array, state)
    r = np.random.default_rng(0)
    for name, st in sn.items():
        c = st["mean"].shape[0]
        st["mean"][:] = 0.1 * r.standard_normal(c)
        st["var"][:] = 0.5 + r.random(c)
        pn[name]["bn"]["gamma"][:] = 1 + 0.2 * r.standard_normal(c)
        pn[name]["bn"]["beta"][:] = 0.1 * r.standard_normal(c)
    jf, _ = jfold.fold_model_jit(jax.tree.map(jnp.asarray, pn), jax.tree.map(jnp.asarray, sn))
    calib = np.random.default_rng(1).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    act = jstatic.calibrate(jconvnet.apply, jf, {}, [calib])
    baked = {sf: jstatic.bake(jf, {}, act, skip_first_layer=sf)[0] for sf in (False, True)}
    x = np.random.default_rng(2).standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    return {"pn": pn, "sn": sn, "jf": jf, "calib": calib, "act": act, "baked": baked, "x": x}


def _carried(tree):
    return interop.from_jax_params(jax.tree.map(np.asarray, tree), {}, device="cpu")[0]


@pytest.fixture
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


@pytest.mark.parametrize("skip_first_layer", [False, True])
def test_bake_matches_jax_bit_for_bit(model, skip_first_layer):
    act = {k: (torch.from_numpy(np.array(s)), torch.from_numpy(np.array(z)))
           for k, (s, z) in model["act"].items()}
    tq, tqs = tstatic.bake(_carried(model["jf"]), {}, act, skip_first_layer=skip_first_layer)
    ref = interop.from_jax_qparams(jax.tree.map(np.asarray, model["baked"][skip_first_layer]), device="cpu")
    assert tqs == {}
    _assert_trees_equal(tq, ref)
    assert isinstance(tq["conv1"]["w"], torch.Tensor) == skip_first_layer
    assert isinstance(tq["fc2"]["aq"], ActQuant) and isinstance(tq["fc2"]["w"], QTensor)


def test_calibrate_matches_jax(model):
    got = tstatic.calibrate(tconvnet.apply, _carried(model["jf"]), {}, [torch.from_numpy(model["calib"])])
    assert set(got) == set(model["act"]) == set(tconvnet.QUANT_LAYERS)
    for key, (js, jz) in model["act"].items():
        ts, tz = got[key]
        assert int(tz) == int(jz), key
        np.testing.assert_allclose(float(ts), float(js), rtol=4e-6, err_msg=key)
    assert float(got["conv1"][0]) == float(model["act"]["conv1"][0])  # the images themselves


def _jax_forward(q, x):
    def forward(q, x):
        capture = {}
        logits, _ = jconvnet.apply(q, {}, x, capture=capture)
        return logits, capture

    logits, capture = jit_unfused(forward, q, jnp.asarray(x))
    return np.asarray(logits), capture


@pytest.mark.parametrize("skip_first_layer", [False, True])
def test_static_convnet_matches_jax(xla, model, skip_first_layer):
    """Every layer after the first receives int8 from its producer, in its
    own domain, the JAX package's bits; fc2 writes f32 logits."""
    jq = model["baked"][skip_first_layer]
    ref, jcap = _jax_forward(jq, model["x"])
    tq = interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu")
    tcap = {}
    got, _ = tconvnet.apply(tq, {}, torch.from_numpy(model["x"]), capture=tcap)
    assert set(tcap) == set(jcap) == set(tconvnet.QUANT_LAYERS)
    for key in tconvnet.QUANT_LAYERS[1:]:
        assert tcap[key].dtype == torch.int8, key
        np.testing.assert_array_equal(tcap[key].numpy(), np.asarray(jcap[key]), err_msg=key)
    assert got.shape == (BATCH, 10) and got.dtype == torch.float32
    if skip_first_layer:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3 * np.abs(ref).max())
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_flags_give_the_same_logits(model):
    tq = interop.from_jax_qparams(jax.tree.map(np.asarray, model["baked"][True]), device="cpu")
    x = torch.from_numpy(model["x"])
    int8_gemm.launches = 0
    a, _ = tconvnet.apply(tq, {}, x)
    b, _ = tconvnet.apply(tq, {}, x, flags=Flags(plain=True))
    assert torch.equal(a, b)
    assert int8_gemm.launches == 0  # CPU tensors take the plain versions


# Layer policies whose handoff plans differ: an fp32 island (fc1) that
# requantizes into the static fc2, and an fp32 stem and classifier.
PLANS = [dict(skip_first_layer=True), dict(layer_policy={"fc1": "fp32", "conv3": "fp32"}),
         dict(skip_first_layer=True, skip_last_layer=True)]


@pytest.mark.parametrize("kwargs", PLANS)
def test_chain_plan_matches_jax(model, kwargs):
    jq, _ = jstatic.bake(model["jf"], {}, model["act"], **kwargs)
    tq = interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu")
    ref = jconvnet._chain_plan(jq)
    got = tconvnet._chain_plan(tq)
    assert set(got) == set(ref), kwargs
    for name in got:
        assert float(got[name].scale) == float(ref[name].scale), name
    assert not tconvnet._chain_plan(_carried(model["pn"]))  # BN not folded: no handoff


@pytest.mark.parametrize("skip_first_layer", [False, True])
def test_quantize_end_to_end(xla, model, skip_first_layer):
    """static.quantize on the port from the unfolded fp32 params: its own fold
    (torch.rsqrt, ROADMAP Queue 3 #2), calibration and bake, against the JAX
    package's static.quantize of the same params on the same batch, within 5%
    of max|logit| (measured 0 with the int8 stem and 0.96% with the fp32
    stem at this seed)."""
    jq, _ = jstatic.quantize(jax.tree.map(jnp.asarray, model["pn"]), jax.tree.map(jnp.asarray, model["sn"]),
                             jconvnet.apply, [model["calib"]], skip_first_layer=skip_first_layer)
    ref, _ = _jax_forward(jq, model["x"])
    tp, ts = interop.from_jax_params(model["pn"], model["sn"], device="cpu")
    tq, _ = tstatic.quantize(tp, ts, tconvnet.apply, [torch.from_numpy(model["calib"])],
                             skip_first_layer=skip_first_layer)
    got, _ = tconvnet.apply(tq, {}, torch.from_numpy(model["x"]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=0.05 * np.abs(ref).max())


def test_static_entry_runs_on_cpu_when_asked():
    fn, (q, qs, x) = static_entry("cpu", batch_size=2, calibration_size=2)
    logits = fn(q, qs, x)
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())
    assert isinstance(q["conv1"]["w"], torch.Tensor) and isinstance(q["conv2"]["aq"], ActQuant)
