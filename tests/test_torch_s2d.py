"""The space-to-depth ResNet stem in the port against the JAX package's, on
the CPU (quantnet/models/resnet.py:188-255).

`fold_stem_s2d` rewrites the 7x7/2 stem as a 4x4/1 conv over 12 channels and
`stem_s2d_input` moves the images into that form; both move data only, so
they are held bit-exact. A ResNet-18 with the folded stem (10 classes, batch
2, 32x32 and the JAX test's 64x64), folded, calibrated and baked by the JAX
package and carried over with interop:
- static INT8, int8 stem (one int8 GEMM at K = 4*4*12 = 192) or fp32 stem:
  every int8 layer input bit-equal; the logits bit-equal at 32x32, where the
  last feature map is 1x1, and within 1e-5 x max|logit| at 64x64, where the
  pool averages 2x2 values in another order;
- fp32: within 1e-5 x max|logit| (f32 convs summed in other orders).
And in the port alone, with an int8 stem: the folded stem quantizes to the
7x7 stem's int8 weights, colsums and input domain (the padded taps carry
zero weights, and the zero padding quantizes to the zero point the 7x7 stem
pads with), and the two trees' logits agree within 1e-3 x max|logit|: the
other layers' scales come from an fp32 calibration forward, whose stem sums
its products in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.models import resnet as jresnet
from quantnet.quantize import fold as jfold
from quantnet.quantize import static as jstatic
from quantnet_torch import interop
from quantnet_torch.models import resnet as tresnet
from quantnet_torch.quantize import static as tstatic

CLASSES = 10


@pytest.fixture(autouse=True)
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def test_fold_stem_s2d_is_bit_exact():
    r = np.random.default_rng(0)
    w = r.standard_normal((7, 7, 3, 64)).astype(np.float32)
    ref = jresnet.fold_stem_s2d({"conv1": {"w": jnp.asarray(w)}})["conv1"]["w"]
    got = tresnet.fold_stem_s2d({"conv1": {"w": torch.from_numpy(w)}})["conv1"]["w"]
    assert got.shape == (4, 4, 12, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="7x7"):
        tresnet.fold_stem_s2d({"conv1": {"w": torch.zeros((3, 3, 3, 8))}})


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (2, 65, 63, 3), (1, 224, 224, 3)])
def test_stem_s2d_input_is_bit_exact(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jresnet.stem_s2d_input(jnp.asarray(x)))
    got = tresnet.stem_s2d_input(torch.from_numpy(x))
    assert got.shape == ref.shape and got.shape[-1] == 12
    np.testing.assert_array_equal(got.numpy(), ref)


def _images(size, seed):
    return np.random.default_rng(seed).standard_normal((2, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    params, state = jresnet.init(jax.random.PRNGKey(0), num_classes=CLASSES, depth=18)
    s2d = jresnet.fold_stem_s2d(params)
    jf, _ = jfold.fold_model_jit(s2d, state)
    calib = [(jnp.asarray(_images(64, 2)), None)]
    act = jstatic.calibrate(jresnet.apply, jf, {}, calib)
    baked = {sf: jstatic.bake(jf, {}, act, skip_first_layer=sf)[0] for sf in (False, True)}
    return {"params": params, "state": state, "s2d": s2d, "jf": jf, "baked": baked}


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("skip_first_layer", [False, True])
def test_static_s2d_resnet_matches_jax(model, skip_first_layer, size):
    jq = model["baked"][skip_first_layer]
    x = _images(size, 3)
    jcap, tcap = {}, {}
    ref, _ = jresnet.apply(jq, {}, jnp.asarray(x), capture=jcap)
    tq = interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu")
    assert tq["conv1"]["w"].shape == (4, 4, 12, 64)
    if not skip_first_layer:
        assert tq["conv1"]["gemm"].b_nk.shape == (64, 192)  # K = 192: no K padding
    got, _ = tresnet.apply(tq, {}, torch.from_numpy(x), capture=tcap)
    assert set(tcap) == set(jcap) and tcap["conv1"].shape[-1] == 12
    for key, ref_in in jcap.items():
        ref_in = np.asarray(ref_in)
        if ref_in.dtype == np.int8:
            np.testing.assert_array_equal(tcap[key].numpy(), ref_in, err_msg=key)
    ref = np.asarray(ref)
    if size == 32:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # Images already in the folded stem's form give the same logits.
    pre, _ = tresnet.apply(tq, {}, tresnet.stem_s2d_input(torch.from_numpy(x)))
    assert torch.equal(pre, got)


def test_fp32_s2d_resnet_matches_jax(model):
    x = _images(64, 4)
    ref, _ = jresnet.apply(model["s2d"], model["state"], jnp.asarray(x))
    tp, ts = interop.from_jax_params(jax.tree.map(np.asarray, model["params"]),
                                     jax.tree.map(np.asarray, model["state"]), device="cpu")
    got, _ = tresnet.apply(tresnet.fold_stem_s2d(tp), ts, torch.from_numpy(x))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_int8_s2d_stem_matches_the_7x7_tree(model):
    tp, ts = interop.from_jax_params(jax.tree.map(np.asarray, model["params"]),
                                     jax.tree.map(np.asarray, model["state"]), device="cpu")
    calib = [torch.from_numpy(_images(32, 5))]
    x = torch.from_numpy(_images(32, 6))
    q7, _ = tstatic.quantize(tp, ts, tresnet.apply, calib)
    q4, _ = tstatic.quantize(tresnet.fold_stem_s2d(tp), ts, tresnet.apply, calib)
    s7, s4 = q7["conv1"], q4["conv1"]
    w7 = tresnet.fold_stem_s2d({"conv1": {"w": s7["w"].values.float()}})["conv1"]["w"]
    assert torch.equal(w7.to(torch.int8), s4["w"].values) and torch.equal(s7["w"].scale, s4["w"].scale)
    assert torch.equal(s7["wsum"], s4["wsum"]) and torch.equal(s7["aq"].scale, s4["aq"].scale)
    assert torch.equal(s7["aq"].zero_point, s4["aq"].zero_point)
    a, _ = tresnet.apply(q7, {}, x)
    b, _ = tresnet.apply(q4, {}, x)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-3 * a.abs().max().item())
    assert torch.equal(a.argmax(1), b.argmax(1))
