"""The mixed-precision policy and the sensitivity sweep, the port against the JAX package.

The convnet at 16x16 from the port's seeded init with non-trivial BN
statistics, folded by the port and handed to both packages as numpy (the
fold is then the identity on both sides). Probe batches: 2 of 4 images.
- The pure functions are equal: static_importance_map, build_policy (ties
  in the ranking included) and guard_from_damage (a layer exactly at the cut
  is not guarded).
- measure_sensitivity: the ranking identical, and each layer's damage
  within a relative bound of the JAX package's. The two packages' f32 convs
  sum in other orders (and XLA's CPU backend contracts multiply-adds into
  FMAs: ROADMAP Queue 3 item 1), so a probed layer's input differs in the
  last places, and where that moves one value of its int8 input across a
  rounding boundary the damage moves by up to about 0.7% at these 8 images
  (measured at fc1, whose per-row scales make one flip count most). conv1
  takes the images themselves: 1e-3 (measured below 1e-4); the other layers
  2e-2. The JAX package's int8 matmul backend matches the port's
  dynamic_linear: `xla` with "unfused", the Pallas kernel (interpret mode)
  with "fused".
- int4_guard and int4_guard_sweep give the same guard sets.
- _apply_policy's tree is bit-equal to the jitted JAX bake, for both low
  tiers; quantize_optimized gives the same table and tree.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from quantnet.core import config as jcfg
from quantnet.models import convnet as jconvnet
from quantnet.quantize import policy as jpolicy
from quantnet_torch.core.config import Flags
from quantnet_torch.core.types import QTensor
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.quantize import fold as tfold
from quantnet_torch.quantize import policy as tpolicy
from test_torch_equalize import _layers, _np, _perturb_bn

DAMAGE_REL = {"conv1": 1e-3}
LAYER_REL = 2e-2
IMAGE = 16
BACKENDS = {"unfused": "xla", "fused": "pallas"}


@pytest.fixture(scope="module")
def model():
    params, state = tconvnet.init(image_size=IMAGE, device="cpu")
    _perturb_bn(params, state, np.random.default_rng(0))
    fp, fs = tfold.fold_model(params, state)
    xs = [np.random.default_rng(i + 1).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
          for i in range(2)]
    return {"tp": fp, "ts": fs, "jp": jax.tree.map(jnp.asarray, _np(fp)),
            "tx": [torch.from_numpy(x) for x in xs], "jx": [jnp.asarray(x) for x in xs]}


@pytest.fixture(autouse=True)
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def _sweep(monkeypatch, model, mode, fn, **kw):
    """fn(apply_fn, params, state, batches, **kw) of both packages, the JAX
    package's dense dynamic lane on the backend that matches `mode`."""
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", BACKENDS[mode])
    with pltpu.force_tpu_interpret_mode():
        ref = jax.block_until_ready(getattr(jpolicy, fn)(jconvnet.apply, model["jp"], {},
                                                         model["jx"], **kw))
    apply_fn = functools.partial(tconvnet.apply, flags=Flags(dynamic_linear=mode))
    got = getattr(tpolicy, fn)(apply_fn, model["tp"], model["ts"], model["tx"], **kw)
    return got, ref


@pytest.mark.parametrize("n", [1, 2, 3, 8, 53])
def test_static_importance_map_matches_jax(n):
    paths = [f"layer{i}" for i in range(n)]
    assert tpolicy.static_importance_map(paths) == jpolicy.static_importance_map(paths)


@pytest.mark.parametrize("fraction", [0.0, 0.25, 0.5, 1.0])
def test_build_policy_matches_jax_with_ties(fraction):
    imp = {"conv1": 1.0, "conv2": 0.5, "conv3": 0.5, "conv4": 0.5, "fc1": 0.2, "fc2": 1.0}
    for low in ("weight_only", "int4"):
        kw = dict(keep_fp32_fraction=fraction, low_precision_scheme=low)
        assert tpolicy.build_policy(imp, **kw) == jpolicy.build_policy(imp, **kw)


@pytest.mark.parametrize("threshold", [1.0, 2.0, 4.0, 50.0])
def test_guard_from_damage_matches_jax_at_the_cut(threshold):
    damage = {"a": 1.0, "b": 1.0, "c": 2.0, "d": 4.0, "e": 8.0}
    got = tpolicy.guard_from_damage(damage, threshold)
    assert got == jpolicy.guard_from_damage(damage, threshold)
    if threshold == 2.0:
        assert got == {"e": "int8"}  # d sits exactly at 2 x the median: not guarded
    assert tpolicy.guard_from_damage({}, threshold) == {}


@pytest.mark.parametrize("mode", list(BACKENDS))
def test_measure_sensitivity_matches_jax(monkeypatch, model, mode):
    got, ref = _sweep(monkeypatch, model, mode, "measure_sensitivity")
    assert list(got) == list(ref) and len(got) == 8
    for path in ref:
        assert got[path] == pytest.approx(ref[path], rel=DAMAGE_REL.get(path, LAYER_REL)), path
    assert sorted(got, key=got.get) == sorted(ref, key=ref.get)


def test_int4_guard_matches_jax(monkeypatch, model):
    got, ref = _sweep(monkeypatch, model, "unfused", "int4_guard", rel_threshold=1.5)
    assert got == ref and got


def test_int4_guard_sweep_matches_jax(monkeypatch, model):
    got, ref = _sweep(monkeypatch, model, "unfused", "int4_guard_sweep",
                      thresholds=(1.25, 1.5, 2.0))
    assert got["guards"] == ref["guards"] and any(got["guards"].values())
    assert got["stable_over_range"] == ref["stable_over_range"]
    assert got["median"] == pytest.approx(ref["median"], rel=LAYER_REL)


def _assert_trees_equal(tree, ref):
    tl, jl = _layers(tree), _layers(ref)
    assert set(tl) == set(jl)
    for path, layer in tl.items():
        j = jl[path]
        w = layer["w"]
        if isinstance(w, QTensor):
            assert (w.bits, w.group_size, w.axis) == (j["w"].bits, j["w"].group_size, j["w"].axis)
            np.testing.assert_array_equal(w.values.numpy(), np.asarray(j["w"].values), err_msg=path)
            np.testing.assert_array_equal(w.scale.numpy(), np.asarray(j["w"].scale), err_msg=path)
        else:
            assert str(w.dtype).split(".")[-1] == str(j["w"].dtype), path
            np.testing.assert_array_equal(w.float().numpy(), np.asarray(j["w"], np.float32),
                                          err_msg=path)
        np.testing.assert_array_equal(layer["b"].float().numpy(), np.asarray(j["b"], np.float32),
                                      err_msg=path)
        assert set(layer) == set(j), path


@pytest.mark.parametrize("low", ["weight_only", "int4"])
def test_apply_policy_bit_equal(model, low):
    paths = list(_layers(model["tp"]))
    policy = {p: ("bf16" if i in (0, 7) else "fp32" if i == 3 else low) for i, p in enumerate(paths)}
    items = tuple(sorted(policy.items()))
    ref, _ = jpolicy._apply_policy(model["jp"], {}, items, True, 128)
    got, _ = tpolicy._apply_policy(model["tp"], model["ts"], items, True, 128)
    _assert_trees_equal(got, ref)


def test_quantize_optimized_matches_jax(monkeypatch, model):
    """The whole scheme: the measured table and the tree it bakes; and with
    the static map, which needs no batches."""
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "pallas")
    with pltpu.force_tpu_interpret_mode():
        jq, _, jpol = jpolicy.quantize_optimized(model["jp"], {}, jconvnet.apply, model["jx"][:1])
        jax.block_until_ready(jq)
    tq, tqs, tpol = tpolicy.quantize_optimized(model["tp"], model["ts"], tconvnet.apply,
                                               model["tx"][:1])
    assert tpol == jpol and tqs == {}
    _assert_trees_equal(tq, jq)
    jq, _, jpol = jpolicy.quantize_optimized(model["jp"], {}, jconvnet.apply, None,
                                             low_precision_scheme="int4")
    tq, _, tpol = tpolicy.quantize_optimized(model["tp"], model["ts"], tconvnet.apply, None,
                                             low_precision_scheme="int4")
    assert tpol == jpol
    _assert_trees_equal(tq, jq)
