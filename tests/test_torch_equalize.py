"""Cross-layer equalization, the port against the JAX package.

Trees come from the port's seeded inits with non-trivial BN statistics,
handed to both packages as numpy (the trees have the same layout).
- `detect_pairs` gives the same pairs on the convnet, ResNet-18 and
  MobileNetV2 0.25.
- Given the same BN-folded tree, `cross_layer_equalize` is bit-equal to the
  JAX package's jitted transform (the port takes XLA's correctly rounded
  sqrt and its (A / B) / C = A / (B * C) rewrite).
- From BN trees each package folds its own: the folds differ in the last
  places (rsqrt, ROADMAP Queue 3 item 2), and the equalized weights then
  agree within 2e-6 x each layer's max |w|.
- On the convnet and ResNet-18 (ReLU) the transform preserves the function:
  the logits stay within 1e-4 relative L2 of the unequalized fold's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.quantize import equalize as jeq
from quantnet_torch import interop
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.models import mobilenet as tmobilenet
from quantnet_torch.models import resnet as tresnet
from quantnet_torch.quantize import equalize as teq
from quantnet_torch.quantize import fold as tfold
from quantnet_torch.quantize.common import layer_paths

FOLD_REL = 2e-6
FUNCTION_REL_L2 = 1e-4

MODELS = {
    "convnet": (lambda: tconvnet.init(image_size=16, device="cpu"), tconvnet.apply, 16),
    "resnet18": (lambda: tresnet.init(depth=18, num_classes=10, device="cpu"), tresnet.apply, 32),
    "mobilenetv2_0.25": (lambda: tmobilenet.init(num_classes=10, width_mult=0.25, device="cpu"),
                         tmobilenet.apply, 32),
}


def _perturb_bn(params, state, r):
    for key, st in state.items():
        if "mean" in st:
            c = st["mean"].shape[0]
            st["mean"][:] = torch.from_numpy(0.1 * r.standard_normal(c).astype(np.float32))
            st["var"][:] = torch.from_numpy((0.5 + r.random(c)).astype(np.float32))
            params[key]["bn"]["gamma"][:] = torch.from_numpy(
                (1 + 0.5 * r.standard_normal(c)).astype(np.float32))
            params[key]["bn"]["beta"][:] = torch.from_numpy(0.1 * r.standard_normal(c).astype(np.float32))
        else:
            _perturb_bn(params[key], st, r)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    init, apply_fn, size = MODELS[request.param]
    params, state = init()
    _perturb_bn(params, state, np.random.default_rng(0))
    return request.param, params, state, apply_fn, size


def _np(tree):
    return jax.tree.map(lambda t: t.numpy().copy(), tree)


def _layers(tree):
    out = {}
    for path in layer_paths(tree):
        node = tree
        for k in path.split("/"):
            node = node[k]
        out[path] = node
    return out


def test_detect_pairs_match_jax(model):
    name, params, state, _, _ = model
    fp, _ = tfold.fold_model(params, state)
    pairs = teq.detect_pairs(fp)
    assert pairs == jeq.detect_pairs(_np(fp)) and len(pairs) > 0
    assert teq.detect_pairs(params) == pairs  # BN trees pair the same


def test_folded_tree_equalizes_bit_for_bit(model):
    _, params, state, _, _ = model
    fp, fs = tfold.fold_model(params, state)
    je, _ = jeq.cross_layer_equalize(jax.tree.map(jnp.asarray, _np(fp)), {})
    te, _ = teq.cross_layer_equalize(fp, fs)
    jl, tl = _layers(je), _layers(te)
    assert set(jl) == set(tl)
    for path, layer in tl.items():
        for k in ("w", "b"):
            np.testing.assert_array_equal(layer[k].numpy(), np.asarray(jl[path][k]), err_msg=path)


def test_bn_tree_within_the_folds_bound(model):
    _, params, state, _, _ = model
    je, _ = jeq.cross_layer_equalize(jax.tree.map(jnp.asarray, _np(params)),
                                     jax.tree.map(jnp.asarray, _np(state)))
    te, _ = teq.cross_layer_equalize(params, state)
    jl, tl = _layers(je), _layers(te)
    for path, layer in tl.items():
        ref = np.asarray(jl[path]["w"])
        np.testing.assert_allclose(layer["w"].numpy(), ref, rtol=0,
                                   atol=FOLD_REL * np.abs(ref).max(), err_msg=path)


@pytest.mark.parametrize("name", ["convnet", "resnet18"])
def test_relu_models_keep_their_function(name):
    init, apply_fn, size = MODELS[name]
    params, state = init()
    _perturb_bn(params, state, np.random.default_rng(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, size, size, 3)).astype(np.float32))
    ref, _ = apply_fn(*tfold.fold_model(params, state), x)
    got, _ = apply_fn(*teq.cross_layer_equalize(params, state), x)
    assert ((got - ref).norm() / ref.norm()).item() < FUNCTION_REL_L2


def test_equalize_balances_ranges_and_keeps_dead_channels():
    """After equalization a pair's per-channel ranges meet at sqrt(r1 r2);
    a dead channel (zero range) keeps scale 1."""
    params, state = tconvnet.init(image_size=16, device="cpu")
    fp, fs = tfold.fold_model(params, state)
    fp["conv1"]["w"][..., 5] = 0.0
    before = fp["conv2"]["w"][:, :, 5].clone()
    te = teq._equalize(fp, (("conv1", "conv2", "conv"),), 1)
    r1 = te["conv1"]["w"].abs().amax(dim=(0, 1, 2))
    r2 = te["conv2"]["w"].abs().amax(dim=(0, 1, 3))
    live = r1 > 0
    torch.testing.assert_close(r1[live], r2[live], rtol=1e-6, atol=0)
    assert torch.equal(te["conv2"]["w"][:, :, 5], before)


def test_interop_carries_the_equalized_tree():
    """An equalized tree runs in the port's quantize transforms like any
    folded tree (interop of the JAX package's equalized tree included)."""
    from quantnet_torch.quantize import dynamic

    params, state = tconvnet.init(image_size=16, device="cpu")
    je, _ = jeq.cross_layer_equalize(jax.tree.map(jnp.asarray, _np(params)),
                                     jax.tree.map(jnp.asarray, _np(state)))
    tp, ts = interop.from_jax_params(jax.tree.map(np.asarray, je), {}, device="cpu")
    qp, _ = dynamic.quantize(tp, ts)
    x = torch.zeros((1, 16, 16, 3))
    assert tconvnet.apply(qp, {}, x)[0].shape == (1, 10)
