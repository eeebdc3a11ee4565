"""Learned rounding (AdaRound), the port against the JAX package.

The JAX package's tiny test model (tests/test_adaround.py: a 3x3 conv of 8
channels on 4x4 images, flatten, a K = 128 dense layer, with the `__specs__`
side channel) and its port twin below take the same numpy weights and
calibration batches (4 batches of 16 images from a numpy seed).
- steps=0 keeps nearest rounding, away from grid midpoints (an exact 0.5
  bakes up, where nearest rounding goes to even).
- _init_rounding: the floors bit-equal to the JAX package's, the logits
  within 1e-5 (their log and log1p round in their own ways).
- After 20 steps every value lies within 1 LSB of nearest rounding and in
  range, and at least 99% of the hard choices equal the JAX package's (its
  optax adam and the port's torch Adam round in other orders, and a soft
  choice near 0.5 may land either way; measured 99.99%).
- A refined static tree keeps its ActQuant, its `wsum` equals the new
  payload's column sums, and its GEMM constants are made from them.
- layer_filter leaves the other layers alone; 120 steps lower the
  reconstruction loss of the hard rounding below nearest rounding's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.quantize import adaround as jada
from quantnet.quantize import static as jstatic
from quantnet.quantize import weight_only as jweight_only
from quantnet_torch import interop
from quantnet_torch.core.types import QTensor
from quantnet_torch.models import capture_input
from quantnet_torch.ops.conv import conv2d
from quantnet_torch.ops.linear import gemm_constants, linear
from quantnet_torch.quantize import adaround as tada
from quantnet_torch.quantize import weight_only as tweight_only
from quantnet_torch.quantize.common import weight_colsum
from test_adaround import tiny_apply as jax_tiny_apply

AGREE_MIN = 0.99


def tiny_apply(params, state, x, *, capture=None):
    """The port's twin of tests/test_adaround.py::tiny_apply."""
    capture_input(capture, "conv1", x, ("conv", 1, "SAME", "relu"))
    x = conv2d(params["conv1"], x, stride=1, padding="SAME", activation="relu")
    x = x.reshape(x.shape[0], -1)
    capture_input(capture, "fc", x, ("linear", None, None, None))
    return linear(params["fc"], x), state


@pytest.fixture(scope="module")
def tiny():
    r = np.random.default_rng(0)
    params = {"conv1": {"w": (r.standard_normal((3, 3, 3, 8)) * 0.3).astype(np.float32),
                        "b": np.zeros(8, np.float32)},
              "fc": {"w": (r.standard_normal((128, 6)) * 0.3).astype(np.float32),
                     "b": (r.standard_normal(6) * 0.05).astype(np.float32)}}
    xs = [r.standard_normal((16, 4, 4, 3)).astype(np.float32) for _ in range(4)]
    return {"jp": jax.tree.map(jnp.asarray, params),
            "tp": jax.tree.map(torch.from_numpy, params), "jx": [(jnp.asarray(x), None) for x in xs],
            "tx": [torch.from_numpy(x) for x in xs]}


@pytest.fixture(autouse=True)
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def _trees(tiny, tier):
    """The JAX package's quantized tree and its port copy."""
    if tier == "weight_only_int4":
        jq, _ = jweight_only.quantize(tiny["jp"], {}, bits=4, group_size=64, skip_last_layer=False)
    else:
        jq, _ = jstatic.quantize(tiny["jp"], {}, jax_tiny_apply, tiny["jx"][:2], weight_bits=4,
                                 weight_group_size=64)
    return jq, interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu")


def test_steps_zero_is_nearest_rounding(tiny):
    tq, _ = tweight_only.quantize(tiny["tp"], {}, bits=4, group_size=64, skip_last_layer=False)
    rq, _ = tada.refine(tq, {}, tiny["tp"], {}, tiny_apply, tiny["tx"][:1], steps=0)
    for path in ("conv1", "fc"):
        w, r = tq[path]["w"], rq[path]["w"]
        grid = tiny["tp"][path]["w"] / tada._scale_full(w)
        away = (grid - torch.floor(grid) - 0.5).abs() > 1e-4
        assert torch.equal(r.values[away], w.values[away]), path
        assert torch.equal(r.scale, w.scale) and (r.bits, r.group_size) == (w.bits, w.group_size)


def test_init_rounding_matches_jax(tiny):
    jq, tq = _trees(tiny, "weight_only_int4")
    paths = ("conv1", "fc")
    jf, jl = jada._init_rounding(jq, tiny["jp"], paths)
    tf, tl = tada._init_rounding(tq, tiny["tp"], paths)
    for p in paths:
        np.testing.assert_array_equal(tf[p].numpy(), np.asarray(jf[p]), err_msg=p)
        np.testing.assert_allclose(tl[p].numpy(), np.asarray(jl[p]), rtol=1e-5, atol=1e-5, err_msg=p)


@pytest.mark.parametrize("tier", ["weight_only_int4", "w4a8"])
def test_refine_agrees_with_jax_within_one_lsb(tiny, tier):
    jq, tq = _trees(tiny, tier)
    jr, _ = jada.refine(jq, {}, tiny["jp"], {}, jax_tiny_apply, tiny["jx"], steps=20)
    tr, _ = tada.refine(tq, {}, tiny["tp"], {}, tiny_apply, tiny["tx"], steps=20)
    agree = total = 0
    for p in ("conv1", "fc"):
        if not isinstance(tq[p]["w"], QTensor):
            continue
        before = tq[p]["w"].values.to(torch.int32)
        after = tr[p]["w"].values.to(torch.int32)
        m = 2 ** (tq[p]["w"].bits - 1) - 1
        assert (after - before).abs().max() <= 1 and after.abs().max() <= m, p
        ref = np.asarray(jr[p]["w"].values)
        agree += int((after.numpy() == ref).sum())
        total += ref.size
    assert total and agree / total >= AGREE_MIN, agree / total


def test_refined_static_tree_keeps_wsum_and_gemm_consistent(tiny):
    _, tq = _trees(tiny, "w4a8")
    tr, _ = tada.refine(tq, {}, tiny["tp"], {}, tiny_apply, tiny["tx"][:2], steps=30)
    moved = False
    for p in ("conv1", "fc"):
        layer = tr[p]
        if not isinstance(layer["w"], QTensor):
            continue
        assert layer["aq"] is tq[p]["aq"]
        assert torch.equal(layer["wsum"], weight_colsum(layer["w"]))
        g, ref = layer["gemm"], gemm_constants(layer)
        assert torch.equal(g.b_nk, ref.b_nk) and torch.equal(g.zpw, ref.zpw)
        moved |= not torch.equal(layer["w"].values, tq[p]["w"].values)
    assert moved
    logits, _ = tiny_apply(tr, {}, tiny["tx"][0])
    assert bool(torch.isfinite(logits).all())


def test_layer_filter_and_the_loss_falls(tiny):
    tq, _ = tweight_only.quantize(tiny["tp"], {}, bits=4, group_size=64, skip_last_layer=False)
    rq, _ = tada.refine(tq, {}, tiny["tp"], {}, tiny_apply, tiny["tx"][:2], steps=60, lr=5e-2,
                        layer_filter=("fc",))
    assert torch.equal(rq["conv1"]["w"].values, tq["conv1"]["w"].values)
    assert not torch.equal(rq["fc"]["w"].values, tq["fc"]["w"].values)
    rq, _ = tada.refine(tq, {}, tiny["tp"], {}, tiny_apply, tiny["tx"], steps=120, lr=2e-2)
    nearest = tada.reconstruction_loss(tq, tiny["tp"], {}, tiny_apply, tiny["tx"])
    refined = tada.reconstruction_loss(rq, tiny["tp"], {}, tiny_apply, tiny["tx"])
    assert refined < nearest, (refined, nearest)
