"""The port's artifact I/O against the JAX package's, on the trained
SimpleConvNet artifacts the repository tracks (runs/r3_cifar/saved/).

- The port's `load_artifact` of each of the nine artifacts gives the JAX
  package's `load_artifact` converted with interop, leaf for leaf and bit for
  bit (dtypes included: bf16 stays bf16, int4 payloads unpack to int8).
- A round trip port -> JAX -> port is bit-equal.
- Eight of them run on both packages on 8 synthetic test images: logits
  within 1e-4 x max|logit| for the float and weight-only schemes (measured
  at most 1.7e-5, bf16) and within 1e-3 x max|logit| for the int8 schemes
  (measured 0: one requantize step at a rounding tie in the fp32 stem would
  show as about 1e-3), with the same argmax. JAX runs its `xla` int8
  backends jitted without XLA's fusion pass, and the port the same per-row
  dynamic quantize (`dynamic_linear="unfused"`).
- W4A8 loads, and its forward raises NotImplementedError naming the batched
  int8 GEMM it needs.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.data.datasets import load_cifar10 as j_load_cifar10
from quantnet.models import convnet as jconvnet
from quantnet.train import checkpoint as jckpt
from quantnet_torch import interop
from quantnet_torch.core.config import Flags
from quantnet_torch.core.types import ActQuant, DynamicActQuant, QTensor
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.ops.linear import GemmConstants
from quantnet_torch.train import checkpoint as tckpt
from test_torch_convnet import jit_unfused

SAVED = pathlib.Path(__file__).resolve().parent.parent / "runs" / "r3_cifar" / "saved"
RUNNABLE = ["fp32", "dynamic", "static", "qat", "weight_only", "weight_only_int4", "bf16", "optimized"]
INT8_SCHEMES = {"dynamic", "static", "qat"}
ALL = RUNNABLE + ["w4a8"]


def _assert_same(a, b, path=""):
    """Two port trees hold the same leaves, bit for bit and dtype for dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, QTensor):
        assert (a.axis, a.bits, a.group_size) == (b.axis, b.bits, b.group_size), path
        for f in ("values", "scale", "zero_point"):
            _assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, ActQuant):
        _assert_same(a.scale, b.scale, path)
        _assert_same(a.zero_point, b.zero_point, path)
    elif isinstance(a, GemmConstants):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _jax_tree_to_port(tree):
    return interop.from_jax_qparams(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("name", ALL)
def test_load_matches_jax(name):
    got, meta = tckpt.load_artifact(str(SAVED / name), device="cpu")
    ref, ref_meta = jckpt.load_artifact(str(SAVED / name))
    assert meta == ref_meta and meta["model"] == "simple_convnet"
    _assert_same(got, _jax_tree_to_port(ref))
    if name == "bf16":
        assert got["params"]["fc1"]["w"].dtype == torch.bfloat16
    if name == "weight_only_int4":
        w = got["params"]["fc1"]["w"]
        assert (w.bits, w.group_size, w.values.dtype) == (4, 128, torch.int8)
        assert int(w.values.abs().max()) <= 7
    if name == "dynamic":
        assert got["params"]["conv1"]["aq"] == DynamicActQuant("bfloat16")


@pytest.mark.parametrize("name", ALL)
def test_round_trip_port_jax_port(tmp_path, name):
    tree, meta = tckpt.load_artifact(str(SAVED / name), device="cpu")
    tckpt.save_artifact(str(tmp_path / "port"), tree, meta)
    jtree, jmeta = jckpt.load_artifact(str(tmp_path / "port"))
    assert jmeta == meta
    jckpt.save_artifact(str(tmp_path / "jax"), jtree, jmeta)
    back, _ = tckpt.load_artifact(str(tmp_path / "jax"), device="cpu")
    _assert_same(back, tree)


@pytest.mark.parametrize("n", [1, 6, 7, 129])
def test_int4_packing_matches_jax(tmp_path, n):
    """Nibble order and the odd-length pad: the port's packing is the JAX
    package's, and each reads the other's."""
    v = np.random.default_rng(n).integers(-7, 8, (n, 1)).astype(np.int8)
    q = QTensor(values=torch.from_numpy(v), scale=torch.ones((1, 1)), axis=1, bits=4)
    tckpt.save_artifact(str(tmp_path / "a"), {"w": q})
    with np.load(tmp_path / "a.npz") as npz:
        packed = npz["w#values"]
    assert packed.dtype == np.uint8 and packed.size == (n + 1) // 2
    np.testing.assert_array_equal(packed & 0xF, (v.reshape(-1)[0::2] + 8).astype(np.uint8))
    ref, _ = jckpt.load_artifact(str(tmp_path / "a"))
    np.testing.assert_array_equal(np.asarray(ref["w"].values), v)
    np.testing.assert_array_equal(tckpt.unpack_int4(tckpt.pack_int4(v), v.shape), v)


@pytest.fixture(scope="module")
def images():
    _, test = j_load_cifar10(synthetic_train_size=8, synthetic_test_size=8)
    return test.images[:8]


@pytest.mark.parametrize("name", RUNNABLE)
def test_trained_artifact_runs_like_jax(monkeypatch, images, name):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")
    jt, _ = jckpt.load_artifact(str(SAVED / name))
    ref = jit_unfused(lambda p, s, x: jconvnet.apply(p, s, x)[0], jt["params"], jt["state"],
                      jnp.asarray(images))
    ref = np.asarray(ref)
    tt, _ = tckpt.load_artifact(str(SAVED / name), device="cpu")
    got, _ = tconvnet.apply(tt["params"], tt["state"], torch.from_numpy(images),
                            flags=Flags(dynamic_linear="unfused"))
    assert got.shape == (8, 10) and got.dtype == torch.float32
    rel = 1e-3 if name in INT8_SCHEMES else 1e-4
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rel * np.abs(ref).max())
    np.testing.assert_array_equal(got.numpy().argmax(1), ref.argmax(1))


def test_w4a8_loads_and_raises(images):
    tree, _ = tckpt.load_artifact(str(SAVED / "w4a8"), device="cpu")
    fc1 = tree["params"]["fc1"]
    assert fc1["w"].group_size == 128 and "gemm" not in fc1
    assert "gemm" in tree["params"]["conv2"]  # per-channel int4 convs run through K1
    with pytest.raises(NotImplementedError, match="batched int8 GEMM"):
        tconvnet.apply(tree["params"], tree["state"], torch.from_numpy(images))
