"""The port's CLI `train` and `qat`, in process, on the CPU (`--device cpu`)
at tiny sizes: train -> fp32 artifact -> qat (8-bit; --weight-bits 4; and
--weight-only --init-from weight_only_int4) -> evaluate, and every artifact
they write loaded by the JAX package.

Bounds, as tests/test_torch_cli.py states them: on 8 synthetic images the
JAX package's forward of the port's artifact (the `xla` int8 backends,
jitted without XLA's fusion pass) gives the port's logits bit for bit for
the static int8 tree, within 1e-3 x max|logit| for W4A8 and 1e-4 x
max|logit| where f32 convs run (fp32, weight-only), with the same argmax.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.models import convnet as jconvnet
from quantnet.train import checkpoint as jckpt
from quantnet_torch.cli.main import build_parser, main
from quantnet_torch.data.datasets import load_cifar10
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.train import checkpoint as tckpt
from test_torch_cli import _dirs
from test_torch_convnet import jit_unfused

SIZES = ["--synthetic-train-size", "128", "--synthetic-test-size", "64", "--batch-size", "32"]
QAT = ["--epochs", "1", "--calibration-batches", "2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_train")
    d = _dirs(base) + SIZES + ["--device", "cpu"]
    out = main(["train", "--epochs", "1", *d])
    main(["qat", *QAT, *d])
    main(["qat", *QAT, "--weight-bits", "4", *d])
    main(["quantize", "--scheme", "weight_only_int4", "--calibration-batches", "2", *d])
    main(["qat", *QAT, "--weight-bits", "4", "--weight-only", "--init-from", "weight_only_int4", *d])
    return base, d, out


def test_train_writes_the_fp32_artifact_history_and_checkpoint(trained):
    base, _, out = trained
    saved = base / "saved"
    for name in ("fp32", "qat", "qat_w4a8", "qat_int4"):
        assert (saved / f"{name}.json").exists() and (saved / f"{name}.npz").exists(), name
    assert (saved / "best.pt").exists()
    history = [json.loads(line) for line in (saved / "history.jsonl").read_text().splitlines()]
    assert [h["epoch"] for h in history] == [0] and history == out["history"]
    meta = json.loads((saved / "fp32.json").read_text())["metadata"]
    assert meta == {"model": "simple_convnet", "best_accuracy": out["best_accuracy"]}
    for name, bits, init in (("qat", 8, None), ("qat_w4a8", 4, None), ("qat_int4", 4, "weight_only_int4")):
        meta = json.loads((saved / f"{name}.json").read_text())["metadata"]
        assert (meta["scheme"], meta["weight_bits"], meta["init_from"]) == (name, bits, init)


def test_evaluate_scores_every_artifact(trained):
    _, d, _ = trained
    out = main(["evaluate", *d])
    assert list(out) == ["fp32", "weight_only_int4", "qat", "qat_int4", "qat_w4a8"]
    assert all(r["n"] == 64 for r in out.values())


@pytest.mark.parametrize("name", ["fp32", "qat", "qat_w4a8", "qat_int4"])
def test_artifacts_run_in_jax(trained, monkeypatch, name):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")
    base, _, _ = trained
    path = str(base / "saved" / name)
    jt, _ = jckpt.load_artifact(path)
    tt, _ = tckpt.load_artifact(path, device="cpu")
    _, test = load_cifar10(str(base / "data"), synthetic_train_size=8, synthetic_test_size=8)
    want = np.asarray(jit_unfused(lambda p, s, x: jconvnet.apply(p, s, x)[0], jt["params"], jt["state"],
                                  jnp.asarray(test.images)))
    got = tconvnet.apply(tt["params"], tt["state"], torch.from_numpy(test.images))[0].numpy()
    if name == "qat":
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-3 if name == "qat_w4a8" else 1e-4
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_qat_trees_have_their_contracts(trained):
    base, _, _ = trained
    trees = {n: tckpt.load_artifact(str(base / "saved" / n), device="cpu")[0]["params"]
             for n in ("qat", "qat_w4a8", "qat_int4")}
    assert trees["qat"]["fc1"]["w"].bits == 8 and "aq" in trees["qat"]["fc1"]
    assert trees["qat_w4a8"]["fc1"]["w"].group_size == 128 and trees["qat_w4a8"]["fc1"]["wsum"].ndim == 2
    assert trees["qat_w4a8"]["conv2"]["w"].bits == 4
    assert "aq" not in trees["qat_int4"]["conv2"] and trees["qat_int4"]["conv2"]["w"].bits == 4
    assert isinstance(trees["qat_int4"]["fc2"]["w"], torch.Tensor)  # the classifier stays f32


def test_resume_goes_on_from_the_checkpoint(trained, capsys):
    base, d, _ = trained
    out = main(["train", "--epochs", "2", "--resume", *d])
    assert "resumed from" in capsys.readouterr().out
    assert [h["epoch"] for h in out["history"]] == [1]


def test_flags_and_defaults_follow_the_jax_cli():
    p = build_parser()
    t = p.parse_args(["train"])
    assert (t.epochs, t.lr, t.optimizer, t.resume, t.aug_rotation, t.aug_color_jitter, t.warmup_epochs,
            t.zero_init_residual) == (20, 0.1, "sgd_cosine", False, 0.0, 0.0, 0.0, False)
    q = p.parse_args(["qat"])
    assert (q.epochs, q.lr, q.optimizer, q.observer, q.calibration_batches, q.grad_clip_norm,
            q.per_tensor, q.skip_first_layer, q.weight_bits, q.weight_group_size, q.weight_only,
            q.init_from, q.int4_guard, q.artifact_name) == (
        2, 0.01, "sgd_cosine", "minmax", 16, 1.0, False, False, 8, 128, False, "", 0.0, "")


def test_refusals(trained, tmp_path):
    _, d, _ = trained
    with pytest.raises(SystemExit, match="sub-byte tier"):
        main(["qat", "--weight-only", *d])
    with pytest.raises(SystemExit, match="not found"):
        main(["qat", "--weight-bits", "4", "--init-from", "w4a8", *d])
    with pytest.raises(SystemExit, match="no fp32 artifact"):
        main(["qat", *_dirs(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="Queue 1 item 4"):
        main(["train", "--dataset", "imagenet", *d])
    with pytest.raises(SystemExit, match="Queue 1 item 4"):
        main(["experiment", "--dataset", "imagenet", *d])
