"""The port's QAT (quantnet_torch/quantize/qat.py and the ops' 'fq' branch)
against the JAX package's quantnet/quantize/qat.py.

Bit-equal: bake and dequantize_tree from the same trees, the baked int8
forward, and prepare's ranges wherever the calibration saw the same floats
(the stem's input: the images). The other layers' ranges come from f32
convs that sum in other orders (ROADMAP Queue 3 item 3, bound 4e-6). The
fake-quant forward and its gradients to stated tolerances, for the same
reason. The PTQ-collapse demonstration runs as tests/test_qat.py runs it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from quantnet.core.types import FakeQuant as JFakeQuant
from quantnet.models import convnet as jconvnet
from quantnet.models import mobilenet as jmobilenet
from quantnet.quantize import qat as jqat
from quantnet_torch import interop
from quantnet_torch.core.types import ActQuant, FakeQuant, QTensor
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.models import mobilenet as tmobilenet
from quantnet_torch.quantize import qat as tqat
from quantnet_torch.quantize.fold import fold_model
from quantnet_torch.train.trainer import clone_tree, cross_entropy, tensor_leaves

from test_torch_convnet import jit_unfused

IMAGE = 16


def _np(tree):
    return jax.tree.map(lambda a: a.detach().numpy().copy() if isinstance(a, torch.Tensor) else a, tree)


@pytest.fixture(scope="module")
def convnet():
    """Seeded convnet weights with BN statistics that fold to real work, and
    a calibration batch, as numpy for both packages."""
    tp, ts = tconvnet.init(torch.Generator().manual_seed(0), image_size=IMAGE, device="cpu")
    p, s = _np(tp), _np(ts)
    r = np.random.default_rng(0)
    for name, st in s.items():
        c = st["mean"].shape[0]
        st["mean"][:] = 0.1 * r.standard_normal(c)
        st["var"][:] = 0.5 + r.random(c)
    x = r.standard_normal((16, IMAGE, IMAGE, 3)).astype(np.float32)
    return p, s, x


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


CONFIGS = {
    "int8": dict(),
    "per_tensor": dict(per_channel=False),
    "w4a8_guard": dict(weight_bits=4, weight_group_size=128, layer_policy={"conv3": "int8"},
                       skip_first_layer=True),
    "int4_weight_only": dict(weight_bits=4, weight_group_size=128, act_quant=False,
                             skip_last_layer=True),
    "histogram": dict(observer="histogram", layer_policy={"conv2": "fp32"}),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_prepare_matches_jax(convnet, config):
    """The same layers get a FakeQuant, with the same grid and flags; the
    stem's range bit-equal, the others within 4e-6."""
    p, s, x = convnet
    kw = CONFIGS[config]
    jp, _ = jqat.prepare(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s), jconvnet.apply,
                         [(jnp.asarray(x), None)], **kw)
    tp, ts = tqat.prepare(_torch_tree(p), _torch_tree(s), tconvnet.apply, [torch.from_numpy(x)], **kw)
    assert ts == {}
    for name in tconvnet.QUANT_LAYERS:
        jfq, tfq = jp[name].get("fq"), tp[name].get("fq")
        assert (jfq is None) == (tfq is None), name
        if tfq is None:
            assert "bn" not in tp[name]
            continue
        assert isinstance(tfq, FakeQuant)
        assert (tfq.zero_point, tfq.per_channel, tfq.weight_bits, tfq.weight_group_size,
                tfq.act_quant) == (jfq.zero_point, jfq.per_channel, jfq.weight_bits,
                                   jfq.weight_group_size, jfq.act_quant), name
        if name == "conv1" or not tfq.act_quant:
            assert tfq.scale == jfq.scale, name
        else:
            assert tfq.scale == pytest.approx(jfq.scale, rel=4e-6), name


def _jax_qat_tree(convnet, kw):
    p, s, x = convnet
    jp, js = jqat.prepare(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s), jconvnet.apply,
                          [(jnp.asarray(x), None)], **kw)
    return jp, js


def _assert_same_quantized_tree(t, j):
    for name in tconvnet.QUANT_LAYERS:
        tl, jl = t[name], j[name]
        assert set(tl) - {"gemm"} == set(jl), name
        if isinstance(tl["w"], QTensor):
            assert (tl["w"].bits, tl["w"].group_size, tl["w"].axis) == (
                jl["w"].bits, jl["w"].group_size, jl["w"].axis)
            np.testing.assert_array_equal(tl["w"].values.numpy(), np.asarray(jl["w"].values))
            np.testing.assert_array_equal(tl["w"].scale.numpy(), np.asarray(jl["w"].scale))
        else:
            np.testing.assert_array_equal(tl["w"].numpy(), np.asarray(jl["w"]))
        if "aq" in jl:
            assert isinstance(tl["aq"], ActQuant) and "gemm" in tl
            np.testing.assert_array_equal(tl["aq"].scale.numpy(), np.asarray(jl["aq"].scale))
            np.testing.assert_array_equal(tl["aq"].zero_point.numpy(), np.asarray(jl["aq"].zero_point))
            np.testing.assert_array_equal(tl["wsum"].numpy(), np.asarray(jl["wsum"]))


@pytest.mark.parametrize("config", ["int8", "per_tensor", "w4a8_guard", "int4_weight_only"])
def test_bake_and_dequantize_bit_equal(convnet, config):
    """From the same QAT tree the port's bake is the JAX package's, leaf for
    leaf, and the baked int8 forward's logits are bit-equal (the weight-only
    tree's f32 convs sum in other orders: within 1e-5); dequantize_tree of
    the same baked tree bit-equal too."""
    jp, js = _jax_qat_tree(convnet, CONFIGS[config])
    tp = interop.from_jax_params(jax.tree.map(np.asarray, jp), {}, device="cpu")[0]
    assert isinstance(tp["conv2"]["fq"], FakeQuant)
    jb, tb = jqat.bake(jp), tqat.bake(tp)
    _assert_same_quantized_tree(tb, jb)
    x = convnet[2][:4]
    want = jit_unfused(lambda p_, x_: jconvnet.apply(p_, {}, x_)[0], jb, x)
    got, _ = tconvnet.apply(tb, {}, torch.from_numpy(x))
    if config == "int4_weight_only":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jd = jqat.dequantize_tree(jb)
    td = tqat.dequantize_tree(interop.from_jax_qparams(jax.tree.map(np.asarray, jb), device="cpu"))
    for name in tconvnet.QUANT_LAYERS:
        assert set(td[name]) == set(jd[name]), name
        np.testing.assert_array_equal(td[name]["w"].numpy(), np.asarray(jd[name]["w"]))


@pytest.mark.parametrize("model", ["convnet", "mobilenetv2_0.25"])
def test_fake_quant_forward_and_gradients_match_jax(convnet, model):
    """The QAT graph (every layer of the folded model fake-quantized; the
    MobileNetV2's depthwise layers included): its loss and every weight's
    gradient against jax.value_and_grad, from the same QAT tree. The two
    packages' f32 convs differ in the last places, and where that moves an
    activation across a rounding boundary of its fake quantizer it moves by
    a whole step: so the loss within 1e-3, and of the gradients' entries 99%
    within 2e-3 (relative, or 2e-4 of the largest gradient), all within 2e-2
    of the largest."""
    if model == "convnet":
        jp, _ = _jax_qat_tree(convnet, {})
        x = convnet[2][:4]
        japply, tapply, classes = jconvnet.apply, tconvnet.apply, 10
    else:
        mp, ms = tmobilenet.init(torch.Generator().manual_seed(1), num_classes=10, width_mult=0.25,
                                 device="cpu")
        x = np.random.default_rng(2).standard_normal((4, 32, 32, 3)).astype(np.float32)
        fp, fs = fold_model(mp, ms)
        jp, _ = jqat.prepare(jax.tree.map(jnp.asarray, _np(fp)), {}, jmobilenet.apply,
                             [(jnp.asarray(x), None)], fold=False)
        japply, tapply, classes = jmobilenet.apply, tmobilenet.apply, 10
    labels = np.arange(4) % classes
    tp = clone_tree(interop.from_jax_params(jax.tree.map(np.asarray, jp), {}, device="cpu")[0],
                    requires_grad=True)

    def jloss(p):
        logits, _ = japply(p, {}, jnp.asarray(x), train=True)
        return -jnp.mean(jnp.sum(jax.nn.one_hot(labels, classes) * jax.nn.log_softmax(logits), -1))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    logits, _ = tapply(tp, {}, torch.from_numpy(x), train=True)
    loss = cross_entropy(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, tensor_leaves(tp))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-3)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    gscale = max(np.abs(np.asarray(g)).max() for g in jleaves)
    t = np.concatenate([g.numpy().ravel() for g in grads])
    j = np.concatenate([np.asarray(g).ravel() for g in jleaves])
    close = np.abs(t - j) <= 2e-3 * np.abs(j) + 2e-4 * gscale
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(t, j, atol=2e-2 * gscale)


def test_baked_forward_tracks_the_fake_quant_graph(convnet):
    """tests/test_qat.py::test_bake_structure_and_numerics in the port: the
    baked int8 logits within rtol 0.05, atol 0.15 of the QAT graph's."""
    p, s, x = convnet
    tp, ts = tqat.prepare(_torch_tree(p), _torch_tree(s), tconvnet.apply, [torch.from_numpy(x)])
    baked = tqat.bake(tp)
    for name in ("conv1", "fc1"):
        assert isinstance(baked[name]["w"], QTensor) and isinstance(baked[name]["aq"], ActQuant)
        assert "wsum" in baked[name] and "fq" not in baked[name]
    xe = torch.from_numpy(np.random.default_rng(5).standard_normal((8, IMAGE, IMAGE, 3)).astype(np.float32))
    fake, _ = tconvnet.apply(tp, ts, xe)
    int8, _ = tconvnet.apply(baked, ts, xe)
    np.testing.assert_allclose(int8.numpy(), fake.numpy(), rtol=0.05, atol=0.15)


@pytest.mark.parametrize("model", ["resnet18", "mobilenetv2_0.25"])
def test_baked_deep_tree_tracks_the_graph_it_deploys(model):
    """A baked ResNet or MobileNetV2 QAT tree reads each residual identity
    as its int8 block input dequantized, where the graph as it trains adds it
    unquantized (in the JAX package too). Against the fake-quant graph with
    those identities fake-quantized (Flags(fake_quant_identity)), the baked
    logits are within chip_smoke.py's relative L2 for the deep trees (an
    activation that the f32 sums put across a rounding boundary moves by a
    whole step, and its consumers with it); its planted bake faults are
    not. Without the flag the graph is the training graph."""
    from quantnet_torch.core.config import Flags
    from quantnet_torch.models import resnet as tresnet

    if model == "resnet18":
        mod = tresnet
        p, s = tresnet.init(torch.Generator().manual_seed(3), depth=18, num_classes=10, device="cpu")
    else:
        mod = tmobilenet
        p, s = tmobilenet.init(torch.Generator().manual_seed(3), num_classes=10, width_mult=0.25,
                               device="cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        for _ in range(3):
            s = mod.apply(p, s, x, train=True)[1]
    tp, ts = tqat.prepare(p, s, mod.apply, [x])
    baked = tqat.bake(tp)
    int8, _ = mod.apply(baked, ts, x)
    deployed, _ = mod.apply(tp, ts, x, flags=Flags(fake_quant_identity=True))
    trained, _ = mod.apply(tp, ts, x)
    assert chip_smoke._rel_l2(int8, deployed) < chip_smoke.QAT_DEEP_REL_L2
    assert not torch.equal(deployed, trained)
    assert torch.equal(trained, mod.apply(tp, ts, x, flags=Flags())[0])
    faults = chip_smoke._planted_faults(torch, mod.apply, baked, ts, x, deployed)
    assert all(rel > chip_smoke.QAT_DEEP_REL_L2 for _, _, rel in faults.values()), faults


def test_qat_recovers_ptq_collapse():
    """tests/test_qat.py::test_qat_recovers_ptq_collapse, run through the
    port (chip_smoke.py runs the same function on the card): the rescale is
    function-preserving, per-tensor PTQ collapses, QAT recovers. On the CPU
    this seed measured fp32 0.4512, PTQ 0.3105, QAT 0.4785."""
    r = chip_smoke.ptq_collapse(torch, "cpu")
    assert r["rescaled"] == pytest.approx(r["fp32"], abs=1e-6)
    assert r["ptq"] <= r["fp32"] - 0.08, r
    assert r["qat"] >= r["ptq"] + 0.05, r


def test_jax_fake_quant_marker_carries_over():
    fq = JFakeQuant(0.25, -3, False, weight_bits=4, weight_group_size=64, act_quant=True)
    tree = interop.from_jax_params({"fc": {"w": np.ones((128, 4), np.float32), "fq": fq}}, {},
                                   device="cpu")[0]
    assert tree["fc"]["fq"] == FakeQuant(0.25, -3, False, 4, 64, True)
