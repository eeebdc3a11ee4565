"""The port's command line, in process, on the CPU (`--device cpu`): the
pipeline import-torch (the committed reference checkpoint) -> quantize
(static and dynamic) -> evaluate -> serve over the u8 wire, at 256 synthetic
test images, and its artifacts held against the JAX package.

Bounds for the port's artifacts run by the JAX package (as
tests/test_torch_artifacts.py states them): the JAX package's `load_artifact`
reads them; on 8 synthetic images its forward (the `xla` int8 backends,
jitted without XLA's fusion pass) gives the port's logits within 1e-4 x
max|logit| for fp32 and 1e-3 x max|logit| for the int8 schemes (one
requantize step at a rounding tie would show as about 1e-3), with the same
argmax; the port runs the dynamic dense layers with the per-row quantize the
JAX `xla` backend uses (`dynamic_linear="unfused"`).
"""
import json
import os
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.models import convnet as jconvnet
from quantnet.train import checkpoint as jckpt
from quantnet_torch.cli.main import build_parser, main
from quantnet_torch.core.config import Flags
from quantnet_torch.data.datasets import load_cifar10
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.train import checkpoint as tckpt
from test_torch_convnet import jit_unfused

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "tests" / "fixtures" / "ref_ckpt_dict.pth")
SAVED = ROOT / "runs" / "r3_cifar" / "saved"
SIZES = ["--synthetic-train-size", "256", "--synthetic-test-size", "256"]


def _dirs(base):
    return ["--save-dir", str(base / "saved"), "--results-dir", str(base / "results"),
            "--data-dir", str(base / "data")]


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    d = _dirs(base) + SIZES + ["--device", "cpu"]
    main(["import-torch", "--ckpt", CKPT, *d])
    for scheme in ("static", "dynamic"):
        main(["quantize", "--scheme", scheme, "--batch-size", "32", "--calibration-batches", "2", *d])
    results = main(["evaluate", "--eval-batch-size", "128", *d])
    return base, d, results


def test_pipeline_writes_artifacts_and_scores(pipeline):
    base, _, results = pipeline
    saved = base / "saved"
    for name in ("fp32", "static", "dynamic"):
        assert (saved / f"{name}.json").exists() and (saved / f"{name}.npz").exists()
    meta = json.loads((saved / "fp32.json").read_text())["metadata"]
    assert meta["best_accuracy"] == 85.42 and meta["torch_pad"] is False
    assert set(results) == {"fp32", "static", "dynamic"}
    table = json.loads((base / "results" / "accuracy.json").read_text())
    assert set(table) == set(results)
    for r in results.values():
        assert r["n"] == 256 and 0.0 <= r["top1"] <= r["top5"] <= 1.0


def test_serve_u8(pipeline, capsys):
    _, d, _ = pipeline
    out = main(["serve", "--wire", "u8", "--requests", "24", "--buckets", "1,8", *d])
    assert out["name"] == "static" and out["stats"]["requests"] == 24
    assert 0 < out["occupancy"] <= 1 and out["latency"]["n"] == 24
    assert "served 24 requests with 'static'" in capsys.readouterr().out


def test_serve_named_scheme(pipeline, capsys):
    """A scheme named with --scheme is served or refused, never swapped for
    another artifact."""
    _, d, _ = pipeline
    out = main(["serve", "--scheme", "dynamic", "--requests", "8", "--buckets", "8", *d])
    assert out["name"] == "dynamic" and out["stats"]["requests"] == 8
    with pytest.raises(SystemExit, match="no artifact for 'bf16'"):
        main(["serve", "--scheme", "bf16", "--requests", "8", *d])


@pytest.mark.parametrize("name", ["fp32", "static", "dynamic"])
def test_port_artifacts_run_in_jax(pipeline, monkeypatch, name):
    base, _, _ = pipeline
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")
    images = load_cifar10(str(base / "data"), synthetic_train_size=8, synthetic_test_size=8)[1].images
    path = str(base / "saved" / name)
    jt, jmeta = jckpt.load_artifact(path)
    tt, tmeta = tckpt.load_artifact(path, device="cpu")
    assert jmeta == tmeta
    ref = np.asarray(jit_unfused(lambda p, s, x: jconvnet.apply(p, s, x)[0], jt["params"], jt["state"],
                                 jnp.asarray(images)))
    got, _ = tconvnet.apply(tt["params"], tt["state"], torch.from_numpy(images),
                            flags=Flags(dynamic_linear="unfused"))
    rel = 1e-4 if name == "fp32" else 1e-3
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rel * np.abs(ref).max())
    np.testing.assert_array_equal(got.numpy().argmax(1), ref.argmax(1))


def test_config_seeds_defaults_and_flags_win(pipeline, tmp_path):
    base, _, _ = pipeline
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"synthetic_test_size": 64, "eval_batch_size": 32}))
    d = _dirs(base) + SIZES[:2] + ["--device", "cpu"]  # the test size comes from the config
    out = main(["evaluate", "--config", str(cfg), "--models", "fp32", *d])
    assert out["fp32"]["n"] == 64
    out = main(["evaluate", "--config", str(cfg), "--models", "fp32", "--synthetic-test-size", "96", *d])
    assert out["fp32"]["n"] == 96


def test_subset_merges_into_accuracy_json(pipeline):
    base, d, _ = pipeline
    path = base / "results" / "accuracy.json"
    before = json.loads(path.read_text())
    out = main(["evaluate", "--models", "static", *d, "--synthetic-test-size", "64"])
    after = json.loads(path.read_text())
    assert set(out) == {"static"} and set(after) == set(before)
    assert after["fp32"] == before["fp32"] and after["static"]["n"] == 64


def test_unknown_model_and_missing_subset_fail(pipeline):
    _, d, _ = pipeline
    with pytest.raises(SystemExit, match="unknown model 'vgg16'"):
        main(["evaluate", "--model", "vgg16", *d])
    with pytest.raises(SystemExit, match="unknown resnet depth"):
        main(["evaluate", "--model", "resnet77", *d])
    with pytest.raises(SystemExit, match="no artifacts for"):
        main(["evaluate", "--models", "bf16", *d])
    with pytest.raises(SystemExit, match="Queue 1 item 4"):
        main(["evaluate", "--dataset", "imagenet", *d])


def test_unported_schemes_and_flags_refused(pipeline, tmp_path, capsys):
    """What only the JAX package does yet is refused by name: ImageNet data
    and the s4 runtime. train and qat are ported (tests/test_torch_cli_train.py);
    report, scaling, experiment and serve --data-parallel too
    (tests/test_torch_report.py, tests/test_torch_serve_dp.py): a mesh
    larger than the local devices raises, as the JAX package's does.
    The artifacts those commands write are not refused: evaluate, bench and
    serve load them (test_optimized_and_qat_artifacts_load). The optimized
    scheme and the accuracy tools' flags are ported
    (tests/test_torch_cli_accuracy.py): quantize takes them."""
    base, d, _ = pipeline
    parser_args = build_parser().parse_args(
        ["quantize", "--scheme", "optimized", "--equalize", "--adaround-steps", "4",
         "--bias-correct", "--int4-guard", "50", "--importance", "static_map",
         "--optimized-low-tier", "int4"])
    assert (parser_args.scheme, parser_args.equalize, parser_args.adaround_steps,
            parser_args.bias_correct, parser_args.int4_guard, parser_args.importance,
            parser_args.optimized_low_tier) == ("optimized", True, 4, True, 50.0, "static_map", "int4")
    defaults = build_parser().parse_args(["quantize"])
    assert (defaults.equalize, defaults.adaround_steps, defaults.bias_correct, defaults.int4_guard,
            defaults.importance, defaults.optimized_low_tier) == (False, 0, False, 0.0, None,
                                                                   "weight_only")
    # bench --s4-runtime parses and benches (no sub-byte tier here: nothing
    # to pack; tests/test_torch_s4_runtime.py benches one).
    assert build_parser().parse_args(["bench", "--s4-runtime"]).s4_runtime
    s4 = main(["bench", "--s4-runtime", "--batch-sizes", "1", "--iters", "1", "--warmup", "0", *d])
    assert set(s4) == {"fp32", "static", "dynamic"}
    capsys.readouterr()
    with pytest.raises(ValueError, match=r"mesh 2x1 needs more than 1 devices"):
        main(["serve", "--data-parallel", "2", *d])
    with pytest.raises(SystemExit, match="Queue 1 item 4"):
        main(["evaluate", "--dataset", "imagenet", *d])
    # An artifact that is not on disk is missing, not unported.
    with pytest.raises(SystemExit, match=r"no artifacts for \['qat'\]"):
        main(["evaluate", "--models", "qat", *d])
    with pytest.raises(SystemExit, match="no artifact for 'optimized'"):
        main(["serve", "--scheme", "optimized", *d])


@pytest.fixture
def with_tracked(pipeline):
    """The pipeline's save dir with the tracked optimized and qat artifacts
    (runs/r3_cifar/saved) copied in, removed afterwards."""
    base, d, _ = pipeline
    copied = [base / "saved" / f"{name}{suffix}" for name in ("optimized", "qat")
              for suffix in (".json", ".npz")]
    for path in copied:
        shutil.copy(SAVED / path.name, path)
    try:
        yield base, d
    finally:
        for path in copied:
            os.remove(path)


def test_optimized_and_qat_artifacts_load(with_tracked, monkeypatch):
    """evaluate and bench list the optimized and qat artifacts beside the
    schemes the port quantized, in the JAX CLI's order; evaluate scores them
    and serve serves them by name."""
    from quantnet_torch.bench.benchmark import InferenceBenchmark

    base, d = with_tracked
    out = main(["evaluate", *d, "--synthetic-test-size", "32"])
    assert list(out) == ["fp32", "dynamic", "static", "optimized", "qat"]
    assert all(r["n"] == 32 for r in out.values())
    # bench measures on the card only; here it lists what it would measure.
    listed = []

    def compare_models(self, models, batch_sizes):
        listed.extend(models)
        return {name: {f"bs{bs}": {"mean_ms": 1.0, "images_per_s": 1.0} for bs in batch_sizes}
                for name in models}

    monkeypatch.setattr(InferenceBenchmark, "compare_models", compare_models)
    main(["bench", *d, "--batch-sizes", "1"])
    assert listed == ["fp32", "dynamic", "static", "optimized", "qat"]
    for scheme in ("optimized", "qat"):
        served = main(["serve", "--scheme", scheme, "--requests", "8", "--buckets", "8", *d])
        assert served["name"] == scheme and served["stats"]["requests"] == 8


def test_tracked_artifact_subset_scores_like_jax(with_tracked, monkeypatch):
    """evaluate --models optimized,qat scores the two artifacts as the JAX
    package's forward does on the same 64 synthetic images: top-1 within one
    image (the dynamic layers' per-row quantize and a requantize at a
    rounding tie may move a near-tie argmax)."""
    from quantnet.data.datasets import load_cifar10 as j_load_cifar10

    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")
    base, d = with_tracked
    out = main(["evaluate", "--models", "optimized,qat", *d, "--synthetic-test-size", "64"])
    assert set(out) == {"optimized", "qat"}
    _, test = j_load_cifar10(str(base / "data"), synthetic_train_size=8, synthetic_test_size=64)
    for name in ("optimized", "qat"):
        jt, _ = jckpt.load_artifact(str(SAVED / name))
        logits = np.asarray(jit_unfused(lambda p, s, x: jconvnet.apply(p, s, x)[0], jt["params"],
                                        jt["state"], jnp.asarray(test.images)))
        top1 = float(np.mean(logits.argmax(1) == test.labels))
        assert out[name]["top1"] == pytest.approx(top1, abs=1 / 64 + 1e-9), name


def test_help_names_what_is_not_ported(capsys):
    with pytest.raises(SystemExit):
        main(["quantize", "--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "--dataset imagenet (Queue 1 item 4)" in text and "Queue 1 item 1" not in text
    assert "w4a8" in text and "optimized" in text  # schemes --scheme takes
    for flag in ("--equalize", "--adaround-steps", "--bias-correct", "--int4-guard",
                 "--importance", "--optimized-low-tier"):
        assert flag in text, flag


def test_default_device_is_the_card(tmp_path):
    """Without --device the CLI runs on the card; on a machine without one it
    raises before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["import-torch", "--ckpt", CKPT, *_dirs(tmp_path)])
    assert not (tmp_path / "saved").exists()


@pytest.fixture(scope="module")
def mobilenet_pipeline(tmp_path_factory):
    """import-torch of a torchvision-layout mobilenet_v2 state dict (random
    weights, seed 5) -> quantize --scheme w4a8 -> evaluate, at 64 synthetic
    CIFAR-10 images."""
    from test_torch_import import _randomize_bn_stats, _TorchMobileNetV2

    base = tmp_path_factory.mktemp("cli_mnv2")
    torch.manual_seed(5)
    m = _TorchMobileNetV2().eval()
    with torch.no_grad():
        _randomize_bn_stats(m, seed=5)
    torch.save(m.state_dict(), base / "mnv2.pth")
    d = _dirs(base) + ["--synthetic-train-size", "64", "--synthetic-test-size", "64",
                       "--device", "cpu", "--model", "mobilenetv2"]
    main(["import-torch", "--ckpt", str(base / "mnv2.pth"), *d])
    main(["quantize", "--scheme", "w4a8", "--batch-size", "32", "--calibration-batches", "1", *d])
    results = main(["evaluate", "--eval-batch-size", "32", *d])
    return base, d, results


def test_mobilenetv2_w4a8_pipeline(mobilenet_pipeline, monkeypatch, capsys):
    """MobileNetV2 through the CLI: its W4A8 artifact (4-bit per-channel
    convs, the fc grouped at g128) scored, served over the u8 wire, and run
    by the JAX package on 8 images within 1e-3 x max|logit|, the same argmax."""
    base, d, results = mobilenet_pipeline
    assert set(results) == {"fp32", "w4a8"} and all(r["n"] == 64 for r in results.values())
    meta = json.loads((base / "saved" / "fp32.json").read_text())["metadata"]
    assert meta["model"] == "mobilenetv2" and meta["torch_pad"] is True
    out = main(["serve", "--scheme", "w4a8", "--wire", "u8", "--requests", "8", "--buckets", "8", *d])
    assert out["name"] == "w4a8" and out["stats"]["requests"] == 8
    with pytest.raises(SystemExit, match="unknown model"):
        main(["evaluate", *d[:-2], "--model", "mobilenetv2_x"])

    from quantnet.models import mobilenet as jmobilenet
    from quantnet_torch.models import mobilenet as tmobilenet

    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")
    images = load_cifar10(str(base / "data"), synthetic_train_size=8, synthetic_test_size=8)[1].images
    path = str(base / "saved" / "w4a8")
    jt, jmeta = jckpt.load_artifact(path)
    tt, tmeta = tckpt.load_artifact(path, device="cpu")
    assert jmeta == tmeta and tt["params"]["fc"]["w"].group_size == 128
    ref = np.asarray(jmobilenet.apply(jt["params"], jt["state"], jnp.asarray(images), torch_pad=True)[0])
    got, _ = tmobilenet.apply(tt["params"], tt["state"], torch.from_numpy(images), torch_pad=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3 * np.abs(ref).max())
    np.testing.assert_array_equal(got.numpy().argmax(1), ref.argmax(1))
