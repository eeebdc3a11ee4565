"""The port CLI's accuracy tools, in process on the CPU (`--device cpu`).

import-torch of the committed reference checkpoint, BN-folded once by the
port and written back as the fp32 artifact (both packages' folds are then
the identity, ROADMAP Queue 3 item 2), then

    quantize --scheme all --equalize --int4-guard 50 --adaround-steps 3
             --bias-correct

on a synthetic split of 64 training images (4 calibration batches of 8),
then evaluate. Held against the JAX package:
- the `optimized` artifact's tree is bit-equal to `quantize_optimized` of
  the JAX package on the same fp32 artifact, equalized by the JAX package,
  and the same calibration batch (the first quarter of four), and its
  `policy` meta is the same table (the JAX package's dense layers run its
  Pallas kernel in interpret mode, as the port's default fused kernel does);
- the JAX package's `load_artifact` reads every artifact the port wrote,
  with the same metadata, and runs the refined and optimized trees;
- weight_only_int4 is per channel under --per-tensor, as the JAX CLI bakes it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from quantnet.core import config as jcfg
from quantnet.data.datasets import load_cifar10 as jload_cifar10
from quantnet.models import convnet as jconvnet
from quantnet.quantize import equalize as jequalize
from quantnet.quantize import policy as jpolicy
from quantnet.quantize import weight_only as jweight_only
from quantnet.train import checkpoint as jckpt
from quantnet_torch.cli.main import RUNNABLE, SCHEMES, main
from quantnet_torch.quantize import fold as tfold
from quantnet_torch.train import checkpoint as tckpt
from test_torch_cli import CKPT, _dirs
from test_torch_policy import _assert_trees_equal

FLAGS = ["--equalize", "--int4-guard", "50", "--adaround-steps", "3", "--bias-correct"]
SIZES = ["--synthetic-train-size", "64", "--synthetic-test-size", "32", "--batch-size", "8"]
CALIB = ["--calibration-batches", "4"]


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_accuracy")
    d = _dirs(base) + SIZES + ["--device", "cpu"]
    main(["import-torch", "--ckpt", CKPT, *d])
    path = str(base / "saved" / "fp32")
    tree, meta = tckpt.load_artifact(path, device="cpu")
    tckpt.save_artifact(path, dict(zip(("params", "state"), tfold.fold_model(tree["params"],
                                                                               tree["state"]))), meta)
    main(["quantize", "--scheme", "all", *FLAGS, *CALIB, *d])
    results = main(["evaluate", "--eval-batch-size", "32", *d])
    return base, d, results


def test_all_eight_artifacts_written_and_scored(pipeline):
    base, _, results = pipeline
    assert SCHEMES[-1] == "optimized" and RUNNABLE[:8] == ("fp32",) + SCHEMES
    assert list(results) == list(RUNNABLE[:8])
    assert all(r["n"] == 32 for r in results.values())


def test_optimized_matches_jax(pipeline, monkeypatch):
    base, _, _ = pipeline
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "pallas")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")
    jt, _ = jckpt.load_artifact(str(base / "saved" / "fp32"))
    params, state = jequalize.cross_layer_equalize(jt["params"], jt["state"])
    train, _ = jload_cifar10(str(base / "data"), synthetic_train_size=64, synthetic_test_size=32)
    calib = [x for x, _ in train.batches(8, drop_remainder=True)][:1]
    with pltpu.force_tpu_interpret_mode():
        jq, _, policy = jpolicy.quantize_optimized(params, state, jconvnet.apply,
                                                   [jnp.asarray(x) for x in calib])
        jax.block_until_ready(jq)
    tt, meta = tckpt.load_artifact(str(base / "saved" / "optimized"), device="cpu")
    assert meta["scheme"] == "optimized" and meta["policy"] == policy
    assert sorted(set(policy.values())) == ["bf16", "weight_only"]
    _assert_trees_equal(tt["params"], jq)


@pytest.mark.parametrize("name", RUNNABLE[:8])
def test_jax_reads_the_ports_artifacts(pipeline, name):
    base, _, _ = pipeline
    path = str(base / "saved" / name)
    jt, jmeta = jckpt.load_artifact(path)
    tt, tmeta = tckpt.load_artifact(path, device="cpu")
    assert jmeta == tmeta
    if name in ("weight_only_int4", "w4a8", "optimized"):
        # The trees only this slice's tools make also run there.
        if name != "optimized":
            fc1 = jt["params"]["fc1"]["w"]
            assert fc1.bits == 4 and fc1.group_size == 128
            np.testing.assert_array_equal(np.asarray(fc1.values),
                                          tt["params"]["fc1"]["w"].values.numpy())
        logits = jax.jit(lambda p, s, x: jconvnet.apply(p, s, x)[0])(
            jt["params"], jt["state"], jnp.zeros((2, 32, 32, 3)))
        assert logits.shape == (2, 10) and bool(jnp.isfinite(logits).all())


def test_weight_only_int4_is_per_channel_under_per_tensor(pipeline):
    """The JAX CLI bakes weight_only_int4 per channel whatever --per-tensor
    says (quantnet/cli/main.py:188-190); the port's CLI does the same."""
    base, d, _ = pipeline
    out = base / "per_tensor"
    d2 = [a if a != str(base / "saved") else str(out) for a in d]
    (out).mkdir()
    for ext in (".json", ".npz"):
        (out / f"fp32{ext}").write_bytes((base / "saved" / f"fp32{ext}").read_bytes())
    main(["quantize", "--scheme", "weight_only_int4", "--per-tensor", *CALIB, *d2])
    jt, _ = jckpt.load_artifact(str(out / "fp32"))
    ref, _ = jweight_only.quantize(jt["params"], jt["state"], bits=4, group_size=128)
    tt, _ = tckpt.load_artifact(str(out / "weight_only_int4"), device="cpu")
    for name in ("conv1", "conv6", "fc1"):
        w = tt["params"][name]["w"]
        assert w.axis is not None or w.group_size is not None, name
        np.testing.assert_array_equal(w.values.numpy(), np.asarray(ref[name]["w"].values))
        np.testing.assert_array_equal(w.scale.numpy(), np.asarray(ref[name]["w"].scale))
    assert isinstance(tt["params"]["fc2"]["w"], torch.Tensor)
