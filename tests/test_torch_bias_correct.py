"""Empirical bias correction, the port against the JAX package.

The convnet at 16x16 from the port's seeded init with non-trivial BN
statistics, folded by the port and handed to both packages as numpy; the
quantized trees are the JAX package's bakes (weight-only int4 g128, and
W4A8 with an fp32 stem), carried over with interop. One calibration batch
of 8 images.
- Only the 'b' leaves change; the port's GEMM constants carry the new bias.
- The shifts (b - b') agree with the JAX package's within 1e-3 x the
  layer's largest shift (measured about 1e-5): the packages' f32 convs and
  sums take other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.models import convnet as jconvnet
from quantnet.quantize import bias_correct as jbc
from quantnet.quantize import static as jstatic
from quantnet.quantize import weight_only as jweight_only
from quantnet_torch import interop
from quantnet_torch.core.types import ActQuant, QTensor
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.ops.linear import gemm_constants
from quantnet_torch.quantize import bias_correct as tbc
from quantnet_torch.quantize import fold as tfold
from test_torch_equalize import _layers, _np, _perturb_bn

SHIFT_REL = 1e-3
IMAGE = 16


@pytest.fixture(scope="module")
def model():
    params, state = tconvnet.init(image_size=IMAGE, device="cpu")
    _perturb_bn(params, state, np.random.default_rng(0))
    fp, fs = tfold.fold_model(params, state)
    x = np.random.default_rng(1).standard_normal((8, IMAGE, IMAGE, 3)).astype(np.float32)
    return {"tp": fp, "ts": fs, "jp": jax.tree.map(jnp.asarray, _np(fp)), "x": x}


@pytest.fixture(autouse=True)
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def _jax_tree(model, tier):
    if tier == "weight_only_int4":
        return jweight_only.quantize(model["jp"], {}, bits=4, group_size=128)
    act = jstatic.calibrate(jconvnet.apply, model["jp"], {}, [jnp.asarray(model["x"])])
    return jstatic.bake(model["jp"], {}, act, skip_first_layer=True, weight_bits=4,
                        weight_group_size=128)


@pytest.mark.parametrize("tier", ["weight_only_int4", "w4a8"])
def test_shifts_match_jax_and_only_biases_change(model, tier):
    jq, jqs = _jax_tree(model, tier)
    jc, _ = jbc.bias_correct(jq, jqs, model["jp"], {}, jconvnet.apply, [jnp.asarray(model["x"])])
    tq = interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu")
    tc, tcs = tbc.bias_correct(tq, {}, model["tp"], model["ts"], tconvnet.apply,
                               [torch.from_numpy(model["x"])])
    assert tcs == {}
    before, after, jafter = _layers(tq), _layers(tc), _layers(jc)
    corrected = 0
    for path, layer in after.items():
        old = before[path]
        assert set(layer) == set(old), path
        for key, leaf in layer.items():
            if key in ("b", "gemm"):
                continue
            if isinstance(leaf, QTensor):
                assert torch.equal(leaf.values, old[key].values) and torch.equal(leaf.scale, old[key].scale)
            elif isinstance(leaf, ActQuant):
                assert leaf is old[key]
            else:
                assert torch.equal(leaf, old[key]), (path, key)
        shift = (old["b"] - layer["b"]).numpy()
        ref = np.asarray(before[path]["b"]) - np.asarray(jafter[path]["b"])
        if not isinstance(layer["w"], QTensor):
            assert not shift.any(), path  # the fp32 layers keep their bias
            continue
        corrected += 1
        np.testing.assert_allclose(shift, ref, rtol=0, atol=SHIFT_REL * np.abs(ref).max(), err_msg=path)
        if "gemm" in layer:
            assert torch.equal(layer["gemm"].bias, gemm_constants(layer).bias)
            assert torch.equal(layer["gemm"].bias, layer["b"])
    assert corrected == 7


def test_corrected_tree_runs_and_needs_specs(model):
    """The corrected W4A8 tree runs through the static path; a model that
    records no specs is refused by name."""
    jq, _ = _jax_tree(model, "w4a8")
    tq = interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu")
    x = torch.from_numpy(model["x"])
    tc, _ = tbc.bias_correct(tq, {}, model["tp"], model["ts"], tconvnet.apply, [x])
    logits, _ = tconvnet.apply(tc, {}, x)
    assert logits.shape == (8, 10) and bool(torch.isfinite(logits).all())

    def no_specs(p, s, xx, capture=None):
        return tconvnet.apply(p, s, xx, capture={} if capture is not None else None)

    with pytest.raises(ValueError, match="__specs__"):
        tbc.bias_correct(tq, {}, model["tp"], model["ts"], no_specs, [x])
    with pytest.raises(ValueError, match="at least one calibration batch"):
        tbc.bias_correct(tq, {}, model["tp"], model["ts"], tconvnet.apply, [])
