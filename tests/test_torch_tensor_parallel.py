"""The port's model axis against the JAX package's tensor parallelism
(counterpart of tests/test_parallel.py:112-136).

The split rule is held against `_spec_for_param` leaf by leaf, and the
slices of every scheme's fc1 and fc2 are checked in one process. One spawned
gloo pair (tests/torch_tensor_parallel_worker.py) runs a 1x2 mesh:

  - the sharded forward of every scheme equals the port's one-rank forward
    of the same tree: bit for bit for static INT8, dynamic INT8 (K2's fc1
    column shard and fc2's row-shard route with the global block absmax;
    the per-row route), and weight-only int8's fc1 column shard; within
    F32_REL of max|logit| where an f32 partial sum of a row shard is added
    in rank order (fp32, weight-only's fp32 classifier, QAT) and where
    W4A8's groups are folded in another association (W4A8_REL);
  - the same forwards against the JAX package's unsharded forward of the
    same tree, jitted as tests/test_torch_convnet.py does, within the
    tolerances those tests hold the one-rank forward to (plus the bound
    above where the sharded forward reassociates);
  - fc2's fake-quant weight with its absmax over the whole K: its rows of
    the one-rank fake-quant weight, bit for bit, and a group that the
    shard's rows split raises;
  - one fp32 train step with augmentation and dropout (and with a clipped
    global norm) against the port's one-process step on the same batch,
    within tests/test_torch_parallel.py's bounds, the replicated leaves
    bit-identical on both ranks.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from quantnet.core import config as jcfg
from quantnet.models import convnet as jconvnet
from quantnet.parallel import mesh as jmesh
from quantnet.quantize import dynamic as jdynamic
from quantnet.quantize import static as jstatic
from quantnet.quantize import weight_only as jweight_only
from quantnet_torch import interop
from quantnet_torch.core.config import Flags, TrainConfig
from quantnet_torch.core.quantize import fake_quant_weight_ste
from quantnet_torch.core.types import QTensor
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.ops.linear import linear
from quantnet_torch.parallel import mesh as meshlib
from quantnet_torch.parallel import tensor
from quantnet_torch.quantize import qat
from quantnet_torch.quantize.common import s4_runtime_tree
from quantnet_torch.train import trainer as ttrainer
from test_torch_convnet import jit_unfused
from test_torch_parallel import _assert_tight
from torch_ranks import spawn_pair
import torch_tensor_parallel_worker as W

IMAGE = 16
BATCH = 4
STEP_BATCH = 16
# An f32 product of a row shard is two partial sums over K = 256 added in
# rank order: the one-rank product sums K = 512 in one. Measured at most a
# few ulps of max|logit| here; the bound leaves room.
F32_REL = 1e-5
# W4A8's fc2 folds its four groups as (g0 + g1) + (g2 + g3) against
# ((g0 + g1) + g2) + g3: a reassociation of four f32 terms.
W4A8_REL = 1e-5
CPU = torch.device("cpu")


@contextlib.contextmanager
def one_thread():
    """The workers' BLAS setting (OMP_NUM_THREADS=1): a CPU f32 product's
    summation order depends on the thread count, not on the slice of N."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


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
    jp, js = jax.tree.map(jnp.asarray, pn), jax.tree.map(jnp.asarray, sn)
    calib = np.random.default_rng(1).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    x = np.random.default_rng(2).standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    jtrees = {
        "static": jstatic.quantize(jp, js, jconvnet.apply, [(calib, None)], skip_first_layer=True)[0],
        "dynamic": jdynamic.quantize(jp, js)[0],
        "w4a8": jstatic.quantize(jp, js, jconvnet.apply, [(calib, None)], weight_bits=4,
                                 weight_group_size=128, skip_first_layer=True)[0],
        "weight_only": jweight_only.quantize(jp, js)[0],
    }
    trees = {k: (interop.from_jax_qparams(jax.tree.map(np.asarray, v), device="cpu"), {})
             for k, v in jtrees.items()}
    trees["fp32"] = interop.from_jax_params(pn, sn, device="cpu")
    trees["w4a8_s4"] = (s4_runtime_tree(trees["w4a8"][0]), {})
    r = np.random.default_rng(3)
    return {"jp": jp, "js": js, "jtrees": jtrees, "trees": trees, "x": x, "calib": calib,
            "fc1_input": r.standard_normal((BATCH, 1024)).astype(np.float32),
            "batch": (r.standard_normal((STEP_BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
                      r.integers(0, 10, STEP_BATCH).astype(np.int64))}


@pytest.fixture(scope="module")
def ranks(model, tmp_path_factory):
    out = tmp_path_factory.mktemp("tensor_parallel")
    torch.save({"trees": model["trees"], "x": torch.from_numpy(model["x"]),
                "calib": torch.from_numpy(model["calib"]),
                "fc1_input": torch.from_numpy(model["fc1_input"]),
                "batch": tuple(torch.from_numpy(b) for b in model["batch"])}, out / "inputs.pt")
    spawn_pair("torch_tensor_parallel_worker.py", out, timeout=300.0)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _one_rank(model, name, flags=Flags()):
    tree, state = model["trees"][name]
    with one_thread():
        return tconvnet.apply(tree, state, torch.from_numpy(model["x"]), flags=flags)[0]


# ---------------------------------------------------------------------------
# The split rule and the slices, in one process
# ---------------------------------------------------------------------------


def test_spec_for_param_mirrors_jax(model):
    """Every leaf of the fp32 params and of each quantized tree gets the
    JAX rule's split: fc1 2-D by columns, fc1 1-D along N, fc2 2-D by rows."""
    want = {(): None, (None, "model"): 1, ("model",): 0, ("model", None): 0}

    def check(tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            names = jmesh._leaf_path_names(path)
            spec = tuple(jmesh._spec_for_param(names, leaf, True))
            assert tensor.spec_for_param(names, np.ndim(leaf), True) == want[spec], names
            assert tensor.spec_for_param(names, np.ndim(leaf), False) is None

    check(model["jp"])
    check(model["js"])
    for tree in model["jtrees"].values():
        check(jax.tree.map(lambda q: q.values if hasattr(q, "values") else q, tree,
                           is_leaf=lambda q: hasattr(q, "values")))


def _fake_mesh(model_rank):
    return meshlib.Mesh("processes", (CPU,), 1, 0, "gloo", 2, model_rank)


@pytest.mark.parametrize("name", ["static", "w4a8", "w4a8_s4", "dynamic", "fp32"])
def test_slices_follow_the_rule(model, name):
    """Rank 1's fc1 holds the upper half of N (payload, per-channel scale or
    grouped scale, colsums, bias, BN's vectors), its fc2 the lower half of
    K (a grouped scale and colsums along G; a per-channel scale, colsums
    and bias whole); each split layer's GEMM constants made from the slice;
    a packed payload packed again."""
    tree, state = model["trees"][name]
    got = tensor.split_params(_fake_mesh(1), tree)
    fc1, fc2 = tree["fc1"], tree["fc2"]
    g1, g2 = got["fc1"], got["fc2"]
    assert (g1["tp"].kind, g2["tp"].kind) == ("column", "row")
    assert (g2["tp"].k, g2["tp"].n, g2["tp"].k_range) == (512, 10, (256, 512))

    def values(w):
        return w.int8_values() if isinstance(w, QTensor) else w

    assert torch.equal(values(g1["w"]), values(fc1["w"])[:, 256:])
    assert torch.equal(values(g2["w"]), values(fc2["w"])[256:])
    assert torch.equal(g1["b"], fc1["b"][256:]) and torch.equal(g2["b"], fc2["b"])
    if isinstance(fc1["w"], QTensor):
        assert g1["w"].is_packed == fc1["w"].is_packed
        if fc1["w"].group_size:
            assert torch.equal(g1["w"].scale, fc1["w"].scale[..., 256:])
            assert torch.equal(g2["w"].scale, fc2["w"].scale[2:])
        else:
            assert torch.equal(g1["w"].scale, fc1["w"].scale[:, 256:])
            assert torch.equal(g2["w"].scale, fc2["w"].scale)
        if "wsum" in fc1:
            assert torch.equal(g1["wsum"], fc1["wsum"][..., 256:])
            want = fc2["wsum"][2:] if fc2["w"].group_size else fc2["wsum"]
            assert torch.equal(g2["wsum"], want)
        if "gemm" in fc1:
            assert g1["gemm"].b_nk.shape[0] == 256
    else:
        assert torch.equal(g1["bn"]["gamma"], fc1["bn"]["gamma"][256:])
        st = tensor.split_params(_fake_mesh(1), state)
        assert torch.equal(st["fc1"]["mean"], state["fc1"]["mean"][256:])
        assert torch.equal(st["conv1"]["mean"], state["conv1"]["mean"])
    assert tensor.gather_params(meshlib.Mesh("processes", (CPU,), 1), tree) is tree


def test_local_mesh_refuses_a_model_axis():
    with pytest.raises(ValueError, match="a local mesh has no model axis"):
        meshlib.make_mesh(2, 2, devices=[CPU] * 4)


# ---------------------------------------------------------------------------
# The 1x2 mesh
# ---------------------------------------------------------------------------


def test_mesh_of_the_pair(ranks):
    r0, r1 = ranks
    assert r0["mesh"] == ({"data": 1, "model": 2}, 0, 0) and r1["mesh"] == ({"data": 1, "model": 2}, 0, 1)
    assert r0["tp_kinds"] == {"fc1": "column", "fc2": "row"}


@pytest.mark.parametrize("name", ["static", "dynamic", "dynamic_per_row"])
def test_sharded_int8_forward_is_bit_equal(model, ranks, name):
    """The int32 accumulators of fc2's row shard are summed exactly, and its
    absmaxes (K2's per-(row, block) one, where fc2's one 512-wide block
    straddles both shards; the per-row one) taken over the model axis."""
    flags = Flags(dynamic_linear="unfused") if name == "dynamic_per_row" else Flags()
    want = _one_rank(model, name.replace("_per_row", ""), flags)
    for r in ranks:
        assert torch.equal(r["logits"][name], want), name


@pytest.mark.parametrize("name", ["static", "dynamic", "weight_only", "w4a8", "w4a8_s4", "fp32"])
def test_fc1_column_shard_is_bit_equal(model, ranks, name):
    tree = model["trees"][name][0]
    fc1 = {k: v for k, v in tree["fc1"].items() if k != "bn"}
    with one_thread():
        want = linear(fc1, torch.from_numpy(model["fc1_input"]))
    for rank, r in enumerate(ranks):
        assert torch.equal(r["fc1"][name], want[:, 256 * rank:256 * (rank + 1)]), (name, rank)


@pytest.mark.parametrize("name,bound", [("fp32", F32_REL), ("weight_only", F32_REL),
                                        ("w4a8", W4A8_REL), ("w4a8_s4", W4A8_REL)])
def test_sharded_forward_within_its_bound(model, ranks, name, bound):
    want = _one_rank(model, name)
    for r in ranks:
        assert _rel(r["logits"][name], want) <= bound, name
    assert torch.equal(ranks[0]["logits"][name], ranks[1]["logits"][name])
    # The s4 payload changes no bit of the sharded forward.
    if name == "w4a8_s4":
        assert torch.equal(ranks[0]["logits"]["w4a8_s4"], ranks[0]["logits"]["w4a8"])


@pytest.fixture
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def _jax_logits(tree, state, x):
    return np.asarray(jit_unfused(lambda q, s, xx: jconvnet.apply(q, s, xx)[0], tree, state,
                                  jnp.asarray(x)))


@pytest.mark.parametrize("name,rtol,bound", [("static", 0.0, 0.0), ("w4a8", 0.0, W4A8_REL),
                                             ("weight_only", 1e-5, F32_REL),
                                             ("dynamic_per_row", 1e-6, 0.0)])
def test_sharded_forward_against_jax(xla, model, ranks, name, rtol, bound):
    """The JAX package's unsharded forward of the same tree (the exact `xla`
    backend), jitted without fusion."""
    jname = name.replace("_per_row", "")
    ref = _jax_logits(model["jtrees"][jname], {}, model["x"])
    got = ranks[0]["logits"][name].numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=(rtol + bound) * np.abs(ref).max())


def test_sharded_dynamic_against_jax_pallas(monkeypatch, model, ranks):
    """The dynamic tree with the fused kernel in interpret mode on the JAX
    side (tests/test_torch_convnet.py's tolerance)."""
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "pallas")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "im2col")
    with pltpu.force_tpu_interpret_mode():
        ref = jax.block_until_ready(jit_unfused(lambda q, xx: jconvnet.apply(q, {}, xx)[0],
                                                model["jtrees"]["dynamic"], jnp.asarray(model["x"])))
    np.testing.assert_allclose(ranks[0]["logits"]["dynamic"].numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_sharded_fp32_against_jax(model, ranks):
    ref, _ = jconvnet.apply(model["jp"], model["js"], jnp.asarray(model["x"]))
    np.testing.assert_allclose(ranks[0]["logits"]["fp32"].numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# QAT's fake quantization over a split K
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["per_channel", "per_tensor", "grouped"])
def test_fc2_fake_quant_takes_the_whole_k(model, ranks, kind):
    """Per channel and per tensor the scale's absmax runs over all 512 rows
    of fc2, not the shard's 256: each rank's fake-quant rows are the
    one-rank weight's, bit for bit. 4-bit groups of 128 lie whole in a
    shard's rows."""
    w = model["trees"]["fp32"][0]["fc2"]["w"]
    args = {"per_channel": (True, 8, None), "per_tensor": (False, 8, None),
            "grouped": (True, 4, 128)}[kind]
    want = fake_quant_weight_ste(w, *args)
    for rank, r in enumerate(ranks):
        assert torch.equal(r["fake_quant"][kind], want[256 * rank:256 * (rank + 1)]), (kind, rank)
    # Taken over the shard alone, the per-tensor scale would differ here.
    if kind == "per_tensor":
        alone = [fake_quant_weight_ste(w[256 * i:256 * (i + 1)], *args) for i in range(2)]
        assert not all(torch.equal(a, want[256 * i:256 * (i + 1)]) for i, a in enumerate(alone))


def test_a_group_split_by_the_shard_raises(ranks):
    """A group of 512 divides fc2's global K but not a shard's 256 rows: the
    grouped grid is refused, not quietly replaced by the per-channel one."""
    for r in ranks:
        assert "splits a group of 512" in r["fake_quant"]["split_group"]


@pytest.mark.parametrize("name", sorted(W.QAT))
def test_sharded_qat_forward(model, ranks, name):
    fp, fs = model["trees"]["fp32"]
    qp, qs = qat.prepare(fp, fs, tconvnet.apply, [torch.from_numpy(model["calib"])],
                         skip_first_layer=True, **W.QAT[name])
    with one_thread():
        want = tconvnet.apply(qp, qs, torch.from_numpy(model["x"]))[0]
    for r in ranks:
        assert _rel(r["qat"][name], want) <= F32_REL, name


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _one_process_step(model, cfg):
    fp, fs = model["trees"]["fp32"]
    images, labels = model["batch"]
    opt = ttrainer.Optimizer(TrainConfig(**cfg), 10)
    p = ttrainer.clone_tree(fp, requires_grad=True)
    leaves = ttrainer.tensor_leaves(p)
    gen = torch.Generator().manual_seed(W.STEP_SEED)
    with one_thread():
        new_state, loss, _ = ttrainer.train_step(
            tconvnet.apply, opt, p, fs, opt.init(leaves), leaves, gen, torch.from_numpy(images),
            torch.from_numpy(labels), augment=True, rotation_deg=15.0, color_jitter=0.2)
    return ttrainer.clone_tree(p), new_state, float(loss)


@pytest.mark.parametrize("key,cfg", [("step", W.STEP_CFG), ("step_clip", W.CLIP_CFG)])
def test_train_step_matches_one_process(model, ranks, key, cfg):
    """fc1's dropout mask is drawn at the global [16, 512] and each rank
    keeps its columns; the input gradient of fc1 is summed over the model
    axis in rank order and the replicated leaves take model index 0's
    gradient, so both ranks hold the same bits."""
    r0, r1 = ranks
    for a, b in zip(r0[key]["replicated"], r1[key]["replicated"]):
        assert torch.equal(a, b)
    assert torch.equal(r0[key]["loss"], r1[key]["loss"])
    _assert_tight(r0[key], *_one_process_step(model, cfg))


def test_clipping_is_active_in_the_clipped_step(model, ranks):
    """The clipped step's threshold is below the gradients' global norm, so
    the clip changes the update: the check sees the model axis's norm."""
    p, _, _ = _one_process_step(model, W.STEP_CFG)
    q, _, _ = _one_process_step(model, W.CLIP_CFG)
    assert _rel(q["fc1"]["w"] - p["fc1"]["w"], p["fc1"]["w"]) > 1e-4
    a, b = ranks[0]["step"]["params"], ranks[0]["step_clip"]["params"]
    assert _rel(b["fc1"]["w"] - a["fc1"]["w"], a["fc1"]["w"]) > 1e-4
