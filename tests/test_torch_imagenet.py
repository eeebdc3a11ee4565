"""The ImageNet track on the CPU: the port's loaders against the JAX
package's (quantnet/data/datasets.py:341-463), the CLI's dataset defaults
and data against the JAX CLI's (quantnet/cli/main.py:107-116,948-958), and
`train` then `experiment --dataset imagenet` at a tiny size.

Tolerance: none. The synthetic split, the decoded uint8 arrays of a tiny
ImageFolder written here by PIL (nothing downloaded), the labels, the
statistics and the normalized batches are bit-equal to the JAX package's.
The JAX package assembles a uint8 split's batches with its native library
(`fma(px, 1/255, -mean) * (1/std)`), as tests/test_torch_native_shuffle.py
compares them.
"""
import json
import sys

import numpy as np
import pytest

from quantnet.cli import main as jcli
from quantnet.data import datasets as jds
from quantnet_torch.cli import main as tcli
from quantnet_torch.data import datasets as tds
from test_torch_cli import _dirs

# (height, width, mode) of each class's files: landscape, portrait, square,
# smaller than the resize, and a grayscale one.
FILES = [[(40, 60, "RGB"), (71, 33, "RGB"), (48, 48, "L")],
         [(30, 30, "RGB"), (50, 90, "RGB")],
         [(64, 41, "RGB"), (36, 36, "RGB"), (97, 55, "RGB"), (20, 28, "RGB")]]
N_FILES = sum(map(len, FILES))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """<root>/imagenet/val/<wnid>/*.JPEG; returns the data dir."""
    from PIL import Image

    root = tmp_path_factory.mktemp("imagenet_data")
    r = np.random.default_rng(0)
    for ci, files in enumerate(FILES):
        cdir = root / "imagenet" / "val" / f"n{ci:08d}"
        cdir.mkdir(parents=True)
        for fi, (h, w, mode) in enumerate(files):
            shape = (h, w) if mode == "L" else (h, w, 3)
            pixels = r.integers(0, 256, shape).astype(np.uint8)
            Image.fromarray(pixels, mode).save(cdir / f"ILSVRC2012_val_{ci * 10 + fi:08d}.JPEG",
                                              quality=90)
    return str(root)


def _assert_same_split(t, j):
    assert (t.name, t.num_classes, len(t)) == (j.name, j.num_classes, len(j))
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.labels.dtype == j.labels.dtype == np.int32
    if j.raw_u8 is None:
        assert t.raw_u8 is None and t.images.dtype == j.images.dtype == np.float32
        np.testing.assert_array_equal(t.images, j.images)
    else:
        assert t.images is None and t.raw_u8.dtype == j.raw_u8.dtype == np.uint8
        np.testing.assert_array_equal(t.raw_u8, j.raw_u8)
        for a, b in ((t.mean, j.mean), (t.std, j.std)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def _assert_same_batches(t, j, batch_size=4, **kw):
    tb, jb = list(t.batches(batch_size, **kw)), list(j.batches(batch_size, **kw))
    assert len(tb) == len(jb) > 0
    for (ti, tl), (ji, jl) in zip(tb, jb):
        assert ti.dtype == ji.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_synthetic_splits_equal_jax(tmp_path):
    """With no imagenet/val on disk, both loaders give the synthetic task,
    "imagenet-synthetic", at image_size 32 with 16 classes."""
    kw = dict(image_size=32, synthetic_train_size=24, synthetic_test_size=20, num_classes=16)
    t, j = tds.load_imagenet(str(tmp_path), **kw), jds.load_imagenet(str(tmp_path), **kw)
    for ts, js, name in zip(t, j, ("imagenet-synthetic-train", "imagenet-synthetic-test")):
        assert ts.name == name
        _assert_same_split(ts, js)
        assert ts.image_shape == (32, 32, 3)
    tv = tds.load_imagenet_val(str(tmp_path), image_size=32, synthetic_size=20, num_classes=16)
    jv = jds.load_imagenet_val(str(tmp_path), image_size=32, synthetic_size=20, num_classes=16)
    _assert_same_split(tv, jv)
    _assert_same_split(tv, t[1])


@pytest.mark.parametrize("image_size", [32, 24])
def test_real_split_equals_jax(folder, image_size):
    """The decoded split: uint8 rows, labels in sorted class order,
    num_classes the folders', ImageNet's mean and std; the same object for
    calibration and val; its batches (in order, and a shuffled training
    epoch) bit-equal."""
    t = tds.load_imagenet(folder, image_size=image_size)
    j = jds.load_imagenet(folder, image_size=image_size)
    assert t[0] is t[1] and j[0] is j[1]
    tv, jv = t[1], j[1]
    assert (tv.name, tv.num_classes, len(tv)) == ("imagenet-val", len(FILES), N_FILES)
    assert tv.image_shape == (image_size, image_size, 3)
    _assert_same_split(tv, jv)
    np.testing.assert_array_equal(tv.labels, np.repeat(np.arange(len(FILES)), list(map(len, FILES))))
    np.testing.assert_array_equal(tv.mean, tds.IMAGENET_MEAN)
    np.testing.assert_array_equal(tv.std, tds.IMAGENET_STD)
    _assert_same_batches(tv, jv)
    _assert_same_batches(tv, jv, shuffle=True, seed=3, drop_remainder=True)
    _assert_same_batches(tv, jv, pad_remainder=True)


@pytest.mark.parametrize("max_images", [0, 1, 4, 5, 100])
def test_max_images_cuts_as_jax(folder, max_images):
    """max_images stops the file list where the JAX function stops it (a
    class's first file is listed before the count is checked, so 0 keeps
    one image, as there)."""
    val = folder + "/imagenet/val"
    t = tds._load_imagenet_real(val, 16, max_images=max_images)
    j = jds._load_imagenet_real(val, 16, max_images=max_images)
    _assert_same_split(t, j)
    assert len(t) == min(max(max_images, 1), N_FILES)


def test_decode_workers_give_the_same_split(folder, monkeypatch):
    val = folder + "/imagenet/val"
    one = tds._load_imagenet_real(val, 32, num_workers=1)
    four = tds._load_imagenet_real(val, 32, num_workers=4)
    _assert_same_split(one, four)
    monkeypatch.setenv("QUANTNET_DECODE_WORKERS", "3")
    _assert_same_split(tds._load_imagenet_real(val, 32), one)


def test_missing_pil_raises_and_never_falls_back(folder, tmp_path, monkeypatch):
    """A val directory with no PIL to decode it raises naming PIL; the
    synthetic split needs no PIL."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
    with pytest.raises(ModuleNotFoundError, match="PIL") as e:
        tds.load_imagenet(folder, image_size=32)
    assert e.value.name == "PIL"
    train, test = tds.load_imagenet(str(tmp_path), image_size=16, synthetic_train_size=4,
                                    synthetic_test_size=4, num_classes=3)
    assert test.name == "imagenet-synthetic-test" and len(test) == 4


# Argument lists for both CLIs, flags given and not.
ARGVS = [
    [],
    ["--dataset", "cifar10"],
    ["--dataset", "imagenet"],
    ["--dataset", "imagenet", "--model", "mobilenetv2"],
    ["--dataset", "imagenet", "--model", "resnet18", "--image-size", "32", "--num-classes", "10"],
    ["--dataset", "imagenet", "--image-size", "16"],
    ["--dataset", "synthetic"],
    ["--dataset", "synthetic", "--model", "resnet50", "--image-size", "24", "--num-classes", "7"],
    ["--dataset", "cifar10", "--model", "mobilenetv2_0.5", "--num-classes", "100"],
]


def _resolved(cli, argv):
    args = cli.build_parser().parse_args(["evaluate", *argv])
    cli._resolve_defaults(args)
    return args


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_cli_defaults_and_data_follow_the_jax_cli(argv, tmp_path):
    sizes = ["--data-dir", str(tmp_path), "--synthetic-train-size", "6", "--synthetic-test-size", "5"]
    t, j = _resolved(tcli, argv + sizes), _resolved(jcli, argv + sizes)
    assert (t.model, t.image_size, t.num_classes) == (j.model, j.image_size, j.num_classes)
    if argv[:2] == ["--dataset", "imagenet"] and len(argv) == 2:
        assert (t.model, t.image_size, t.num_classes) == ("resnet50", 224, 1000)
    if not argv:
        assert (t.model, t.image_size, t.num_classes) == ("simple_convnet", 32, 10)
    ttrain, ttest, tclasses = tcli._load_data(t)
    jtrain, jtest, jclasses = jcli._load_data(j)
    assert tclasses == jclasses
    _assert_same_split(ttrain, jtrain)
    _assert_same_split(ttest, jtest)


def test_cli_loads_the_real_split_as_jax(folder):
    t = _resolved(tcli, ["--dataset", "imagenet", "--image-size", "32", "--data-dir", folder])
    j = _resolved(jcli, ["--dataset", "imagenet", "--image-size", "32", "--data-dir", folder])
    ttrain, ttest, _ = tcli._load_data(t)
    _, jtest, _ = jcli._load_data(j)
    assert ttrain is ttest
    _assert_same_split(ttest, jtest)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """train, then experiment --dataset imagenet --importance static_map
    --skip-training --qat-epochs 0: ResNet-18 at 32x32 with 10 classes, 64
    synthetic images."""
    base = tmp_path_factory.mktemp("imagenet_cli")
    d = _dirs(base) + ["--dataset", "imagenet", "--model", "resnet18", "--image-size", "32",
                       "--num-classes", "10", "--synthetic-train-size", "64", "--synthetic-test-size",
                       "64", "--batch-size", "32", "--device", "cpu"]
    trained = tcli.main(["train", "--epochs", "1", *d])
    out = tcli.main(["experiment", "--skip-training", "--importance", "static_map", "--qat-epochs", "0",
                     "--calibration-batches", "2", "--batch-sizes", "1", "--warmup", "0", "--iters", "1",
                     *d])
    return base, d, trained, out


def test_experiment_writes_the_report(experiment):
    base, _, trained, out = experiment
    assert len(trained["history"]) == 1
    fp32 = json.loads((base / "saved" / "fp32.json").read_text())["metadata"]
    assert fp32["model"] == "resnet18"
    schemes = ["fp32", "bf16", "dynamic", "static", "weight_only", "weight_only_int4", "w4a8",
               "optimized"]
    assert list(out["accuracy"]) == schemes == list(out["benchmark"])
    assert all(r["n"] == 64 for r in out["accuracy"].values())
    report = (base / "results" / "detailed_analysis_report.md").read_text()
    rows = [ln.split(" | ")[0][2:] for ln in report.splitlines()
            if ln.startswith("| ") and not ln.startswith("| model")]
    assert rows == schemes
    assert all((base / "results" / f).exists() for f in
               ("accuracy.json", "benchmark.json", "quantization_comparison.csv"))
    optimized = json.loads((base / "saved" / "optimized.json").read_text())["metadata"]
    assert optimized["policy"] and set(optimized["policy"].values()) <= {"bf16", "weight_only"}


def test_evaluate_on_the_real_split(experiment, folder, tmp_path):
    """evaluate --dataset imagenet on the decoded ImageFolder: the head keeps
    its 10 classes, the split has 3; every image is scored."""
    _, d, _, _ = experiment
    out = tcli.main(["evaluate", "--models", "static,fp32", *d, "--data-dir", folder,
                     "--results-dir", str(tmp_path)])
    assert set(out) == {"static", "fp32"} and all(r["n"] == N_FILES for r in out.values())
