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
from quantnet_torch.cli.main import main
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
    with pytest.raises(SystemExit, match="Queue 1 item 5"):
        main(["evaluate", "--dataset", "imagenet", *d])


def test_unported_schemes_and_flags_refused(pipeline, tmp_path, capsys):
    base, d, _ = pipeline
    for argv in (["quantize", "--scheme", "w4a8"], ["quantize", "--scheme", "optimized"],
                 ["quantize", "--equalize"], ["quantize", "--adaround-steps", "4"],
                 ["quantize", "--bias-correct"], ["quantize", "--int4-guard", "50"],
                 ["serve", "--data-parallel", "2"], ["bench", "--s4-runtime"], ["train"]):
        with pytest.raises(SystemExit) as e:
            main([*argv, *d])
        assert e.value.code == 2, argv  # argparse refuses it
    capsys.readouterr()
    with pytest.raises(SystemExit, match="Queue 1 item 1"):
        main(["evaluate", "--models", "w4a8", *d])
    with pytest.raises(SystemExit, match="Queue 1 item 4"):
        main(["serve", "--scheme", "optimized", *d])
    # Loading every artifact leaves the unported ones out, naming them.
    for suffix in (".json", ".npz"):
        shutil.copy(SAVED / f"w4a8{suffix}", base / "saved" / f"w4a8{suffix}")
    try:
        out = main(["evaluate", *d, "--synthetic-test-size", "32"])
    finally:
        for suffix in (".json", ".npz"):
            os.remove(base / "saved" / f"w4a8{suffix}")
    assert "w4a8" not in out
    assert "left out, not ported yet: w4a8 (ROADMAP Queue 1 item 1" in capsys.readouterr().err


def test_help_names_what_is_not_ported(capsys):
    with pytest.raises(SystemExit):
        main(["quantize", "--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "w4a8 scheme (ROADMAP Queue 1 item 1)" in text and "--int4-guard (Queue 1 item 4)" in text


def test_default_device_is_the_card(tmp_path):
    """Without --device the CLI runs on the card; on a machine without one it
    raises before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["import-torch", "--ckpt", CKPT, *_dirs(tmp_path)])
    assert not (tmp_path / "saved").exists()
