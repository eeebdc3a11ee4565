"""The port's `.pth` importer against the JAX package's.

Both reference formats (the committed fixtures) and torchvision-shaped
ResNet state dicts built in the test go through both importers; the trees
must be the same bits, since each only relays out the stored f32 values.
The forward of an imported ResNet-50 runs with torch_pad and is held
against the torch module the state dict came from, within 1e-4 x max|logit|
(the f32 convs sum in another order than torch's; measured 5.3e-7 at this
seed), and against the JAX package's forward of its own import under the
same bound (measured 6.8e-7).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.models import resnet as jresnet
from quantnet.models import torch_import as jimport
from quantnet_torch import interop
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.models import resnet as tresnet
from quantnet_torch.models import torch_import as timport
from test_torch_import import _randomize_bn_stats, _synthetic_resnet50_state_dict, _TorchResNet50
from test_torch_resnet import _assert_trees_equal

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _carried(params, state):
    return interop.from_jax_params(jax.tree.map(np.asarray, params),
                                   jax.tree.map(np.asarray, state), device="cpu")


@pytest.mark.parametrize("name,best", [("ref_ckpt_dict.pth", 85.42), ("ref_ckpt_raw.pth", None)])
def test_fixture_matches_jax_import(name, best):
    path = os.path.join(FIX, name)
    tp, ts, tbest = timport.import_checkpoint(path, device="cpu")
    jp, js, jbest = jimport.import_checkpoint(path)
    assert tbest == jbest == best
    rp, rs = _carried(jp, js)
    _assert_trees_equal(tp, rp)
    _assert_trees_equal(ts, rs)
    sd = timport.load_torch_checkpoint(path)
    assert "conv1.weight" in sd and "fc2.bias" in sd


def test_fixture_forward_runs():
    params, state, _ = timport.import_checkpoint(os.path.join(FIX, "ref_ckpt_dict.pth"), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32))
    logits, _ = tconvnet.apply(params, state, x)
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()


def test_resnet50_tree_matches_jax_import():
    sd = _synthetic_resnet50_state_dict()
    tp, ts = timport.resnet50_from_torch(sd, device="cpu")
    rp, rs = _carried(*jimport.resnet50_from_torch(sd))
    _assert_trees_equal(tp, rp)
    _assert_trees_equal(ts, rs)


def test_resnet18_tree_from_state_dict():
    """A basic-block state dict: the structure is read off the keys."""
    ref_p, ref_s = tresnet.init(torch.Generator().manual_seed(0), depth=18, num_classes=10, device="cpu")
    sd = {}

    def put(layer, st, key, bn):
        sd[f"{key}.weight"] = layer["w"].permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
        sd[f"{bn}.weight"], sd[f"{bn}.bias"] = layer["bn"]["gamma"], layer["bn"]["beta"]
        sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"] = st["mean"], st["var"]

    put(ref_p["conv1"], ref_s["conv1"], "conv1", "bn1")
    for si in range(4):
        for bi, bp in ref_p[f"layer{si + 1}"].items():
            bs = ref_s[f"layer{si + 1}"][bi]
            t = f"layer{si + 1}.{bi}"
            for name in bp:
                key = f"{t}.downsample.0" if name == "downsample" else f"{t}.{name}"
                bn = f"{t}.downsample.1" if name == "downsample" else f"{t}.bn{name[-1]}"
                put(bp[name], bs[name], key, bn)
    sd["fc.weight"], sd["fc.bias"] = ref_p["fc"]["w"].t().contiguous(), ref_p["fc"]["b"]
    tp, ts = timport.resnet_from_torch(sd, device="cpu")
    _assert_trees_equal(tp, ref_p)
    _assert_trees_equal(ts, ref_s)


@pytest.fixture(scope="module")
def torch_resnet50():
    torch.manual_seed(1)
    m = _TorchResNet50().eval()
    with torch.no_grad():
        _randomize_bn_stats(m, seed=1)
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        ref = m(torch.from_numpy(x)).numpy()
    return m.state_dict(), x.transpose(0, 2, 3, 1).copy(), ref


def test_resnet50_forward_parity_under_torch_pad(torch_resnet50):
    sd, x, ref = torch_resnet50
    tp, ts = timport.resnet50_from_torch(sd, device="cpu")
    got, _ = tresnet.apply(tp, ts, torch.from_numpy(x), torch_pad=True)
    got = got.numpy()
    bound = 1e-4 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
    jp, js = jimport.resnet50_from_torch(sd)
    jgot = np.asarray(jax.jit(lambda p, s, x: jresnet.apply(p, s, x, torch_pad=True)[0])(jp, js, jnp.asarray(x)))
    assert np.abs(got - jgot).max() <= bound
    # Without torch_pad the stride-2 convs sample other positions.
    off, _ = tresnet.apply(tp, ts, torch.from_numpy(x))
    assert np.abs(off.numpy() - ref).max() > 1e-2 * np.abs(ref).max()


def test_mobilenet_and_unknown_models_raise():
    path = os.path.join(FIX, "ref_ckpt_raw.pth")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        timport.import_checkpoint(path, "mobilenetv2", device="cpu")
    with pytest.raises(ValueError):
        timport.import_checkpoint(path, "vgg16", device="cpu")
