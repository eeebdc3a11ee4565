"""The port's data, evaluator and bench helpers against the JAX package's.

- `make_synthetic` / `load_cifar10`: the same numpy arrays from the same
  seed, and the CIFAR-10 pickle reader on a small split written here.
- `Evaluator`, `compare_models` and `compare_models_single_pass` on fixed
  logits: top-1, top-5 and per-class equal to the JAX package's.
- `estimate_flops`: 2 x MACs from the layers' shapes, equal to the JAX
  package's jaxpr walk on the fp32 model (convnet at 32x32, ResNet-18 at
  64x64), and the same under every scheme.
- `tree_nbytes`, the bench's model size, equal to the JAX package's.
- Without a card, every measurement entry point raises.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.bench.benchmark import _flops_of_jaxpr
from quantnet.core.types import tree_nbytes as j_tree_nbytes
from quantnet.data import datasets as jdata
from quantnet.evaluation import evaluator as jeval
from quantnet.models import convnet as jconvnet
from quantnet.models import resnet as jresnet
from quantnet_torch import interop
from quantnet_torch.bench import benchmark as tbench
from quantnet_torch.core.types import tree_nbytes
from quantnet_torch.data import datasets as tdata
from quantnet_torch.evaluation import evaluator as teval
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.models import resnet as tresnet
from quantnet_torch.quantize import bf16, dynamic, static, weight_only
from quantnet_torch.train import checkpoint as tckpt
from test_torch_artifacts import SAVED


def _same_dataset(got, ref):
    assert (got.num_classes, got.name, len(got)) == (ref.num_classes, ref.name, len(ref))
    for bs, pad in ((7, True), (16, True), (16, False)):
        pairs = zip(got.batches(bs, pad_remainder=pad), ref.batches(bs, pad_remainder=pad), strict=True)
        for (gi, gl), (ri, rl) in pairs:
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_array_equal(gl, rl)


@pytest.mark.parametrize("args", [(10, 32, 40, 21, 1234), (3, 12, 9, 5, 7)])
def test_make_synthetic_matches_jax(args):
    for got, ref in zip(tdata.make_synthetic(*args), jdata.make_synthetic(*args)):
        assert got.images.dtype == np.float32 and got.labels.dtype == np.int32
        np.testing.assert_array_equal(got.images, ref.images)
        _same_dataset(got, ref)


def test_load_cifar10_falls_back_to_the_synthetic_task(tmp_path):
    got = tdata.load_cifar10(str(tmp_path), synthetic_train_size=20, synthetic_test_size=11)
    ref = jdata.load_cifar10(str(tmp_path), synthetic_train_size=20, synthetic_test_size=11)
    for g, r in zip(got, ref):
        assert g.name.startswith("cifar10-synthetic")
        _same_dataset(g, r)


def test_cifar10_pickles_are_read_like_jax(tmp_path):
    """A split of the real format (python pickles of uint8 CHW rows) written
    here: the same labels, and the same normalized f32 batches."""
    batch_dir = tmp_path / "cifar-10-batches-py"
    batch_dir.mkdir()
    r = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        blob = {b"data": r.integers(0, 256, (6, 3072)).astype(np.uint8),
                b"labels": r.integers(0, 10, 6).tolist()}
        with open(batch_dir / name, "wb") as f:
            pickle.dump(blob, f)
    got, ref = tdata.load_cifar10(str(tmp_path)), jdata.load_cifar10(str(tmp_path))
    for g, rr in zip(got, ref):
        assert g.raw_u8.dtype == np.uint8 and g.images is None
        np.testing.assert_array_equal(g.raw_u8, rr.raw_u8)
        _same_dataset(g, rr)


class _Fixed:
    """A model whose logits are a fixed function of the image: its first 10
    values times a weight, on either package."""

    @staticmethod
    def jax(params, state, x, train=False):
        return x.reshape(x.shape[0], -1)[:, :10] * params["s"], state

    @staticmethod
    def port(params, state, x):
        return x.reshape(x.shape[0], -1)[:, :10] * params["s"], state


@pytest.fixture(scope="module")
def scored():
    _, test = jdata.make_synthetic(10, 4, 8, 45, seed=5)
    _, ttest = tdata.make_synthetic(10, 4, 8, 45, seed=5)
    return test, ttest


def _same_result(got, ref):
    assert set(got) == set(ref)
    for key in ("top1", "top5", "n", "num_classes"):
        assert got[key] == pytest.approx(ref[key], rel=0, abs=0), key
    assert got["per_class"] == ref["per_class"]


@pytest.mark.parametrize("batch_size", [16, 45, 64])
def test_evaluator_matches_jax(scored, batch_size):
    test, ttest = scored
    names = jdata.CIFAR10_CLASSES
    ref = jeval.Evaluator(_Fixed.jax, test, batch_size=batch_size, class_names=names).evaluate(
        {"s": jnp.float32(1.0)}, {})
    got = teval.Evaluator(_Fixed.port, ttest, batch_size=batch_size, class_names=names,
                          device="cpu").evaluate({"s": torch.tensor(1.0)}, {})
    _same_result(got, ref)
    assert got["n"] == 45 and 0 < got["top1"] < got["top5"] < 1


def test_compare_models_matches_jax(scored):
    test, ttest = scored
    jmodels = {"a": (_Fixed.jax, {"s": jnp.float32(1.0)}, {}), "b": (_Fixed.jax, {"s": jnp.float32(-1.0)}, {})}
    tmodels = {"a": (_Fixed.port, {"s": torch.tensor(1.0)}, {}), "b": (_Fixed.port, {"s": torch.tensor(-1.0)}, {})}
    ref = jeval.compare_models(jmodels, test, batch_size=16)
    got = teval.compare_models(tmodels, ttest, batch_size=16, device="cpu")
    single = teval.compare_models_single_pass(
        _Fixed.port, {k: v[1:] for k, v in tmodels.items()}, ttest, batch_size=16, device="cpu")
    ref_single = jeval.compare_models_single_pass(
        _Fixed.jax, {k: v[1:] for k, v in jmodels.items()}, test, batch_size=16)
    for name in ("a", "b"):
        _same_result(got[name], ref[name])
        _same_result(single[name], ref_single[name])


def test_metric_step_counts_by_hand():
    logits = torch.tensor([[0.1, 0.9, 0.0], [0.8, 0.1, 0.3], [0.2, 0.3, 0.5], [0.9, 0.0, 0.1]])
    labels = torch.tensor([1, 2, 2, 0])
    valid = torch.tensor([True, True, True, False])  # the last row is padding
    got = teval.metric_step(logits, labels, valid, 3, top_k=2).tolist()
    # top-1 hits rows 0 and 2, top-2 rows 0-2; per class correct / total.
    assert got == [2, 3, 3, 0, 1, 1, 0, 1, 2]


def _jax_fp32_flops(jmodel, params, state, x):
    fn = lambda p, s, xx: jmodel.apply(p, s, xx, train=False)[0]  # noqa: E731
    return _flops_of_jaxpr(jax.make_jaxpr(fn)(params, state, x).jaxpr)


def _schemes(tmodel, params, state, x):
    """The fp32 model and every scheme the port builds from it."""
    out = {"fp32": (params, state), "dynamic": dynamic.quantize(params, state),
           "weight_only": weight_only.quantize(params, state),
           "weight_only_int4": weight_only.quantize(params, state, bits=4, group_size=128),
           "bf16": bf16.quantize(params, state)}
    out["static"] = static.quantize(params, state, tmodel.apply, [x], skip_first_layer=True)
    return out


@pytest.mark.parametrize("kind", ["convnet", "resnet18"])
def test_estimate_flops_matches_jax(kind):
    if kind == "convnet":
        jp, js = jconvnet.init(jax.random.PRNGKey(0))
        jmodel, tmodel, image = jconvnet, tconvnet, 32
    else:
        jp, js = jresnet.init(jax.random.PRNGKey(0), depth=18)
        jmodel, tmodel, image = jresnet, tresnet, 64
    x = np.random.default_rng(0).standard_normal((2, image, image, 3)).astype(np.float32)
    ref = _jax_fp32_flops(jmodel, jp, js, jnp.asarray(x))
    tp, ts = interop.from_jax_params(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js), device="cpu")
    tx = torch.from_numpy(x)
    for name, (q, qs) in _schemes(tmodel, tp, ts, tx).items():
        assert tbench.estimate_flops(tmodel.apply, q, qs, tx) == ref, name


def test_tree_nbytes_matches_jax():
    from quantnet.train import checkpoint as jckpt

    for name in ("fp32", "dynamic", "static", "weight_only_int4", "bf16", "w4a8"):
        tree, _ = tckpt.load_artifact(str(SAVED / name), device="cpu")
        ref, _ = jckpt.load_artifact(str(SAVED / name))
        assert tree_nbytes(tree["params"]) == j_tree_nbytes(ref["params"]), name


def test_roofline_fields_and_compute_dtype():
    tp, ts = tconvnet.init(torch.Generator().manual_seed(0), image_size=8, device="cpu")
    x = torch.zeros((1, 8, 8, 3))
    dtypes = {name: tbench.compute_dtype(q) for name, (q, _) in _schemes(tconvnet, tp, ts, x).items()}
    assert dtypes == {"fp32": "float32", "dynamic": "int8", "weight_only": "float32",
                      "weight_only_int4": "float32", "bf16": "bfloat16", "static": "int8"}
    q, _ = dynamic.quantize(tp, ts)
    fields = tbench.roofline_fields(q, 2e9, 2.0, "NVIDIA H100 80GB HBM3")
    assert fields == pytest.approx({"model_gops": 2.0, "achieved_tops": 1.0, "peak_tops": 1979.0,
                                    "mfu": 1.0 / 1979.0})
    assert set(tbench.roofline_fields(q, 2e9, 2.0, "another card")) == {"model_gops", "achieved_tops"}
    assert tbench.roofline_fields(q, 0.0, 2.0, "another card") == {}


def test_measurements_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract does not apply")
    import bench_torch

    tp, ts = tconvnet.init(torch.Generator().manual_seed(0), image_size=8, device="cpu")
    bench = tbench.InferenceBenchmark(image_size=8, warmup=1, iters=1)
    for call in (lambda: bench.measure(tconvnet.apply, tp, ts, 1),
                 lambda: bench.compare_models({"fp32": (tconvnet.apply, tp, ts)}),
                 bench_torch.main,
                 lambda: teval.Evaluator(tconvnet.apply, tdata.make_synthetic(10, 8, 1, 1)[1]),
                 lambda: tckpt.load_artifact(str(SAVED / "fp32"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
