"""The port's dynamic-INT8 SimpleConvNet against the JAX package, whole.

Small size: 16x16 inputs at batch 2, which gives fc1 K = 1024 (two K-blocks of
the fused kernel) at full widths 64/128/256 and 512. Weights come from the
JAX package's init and are carried over with quantnet_torch.interop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from quantnet.core import config as jcfg
from quantnet.models import convnet as jconvnet
from quantnet.ops import linear as jlinear
from quantnet.quantize import dynamic as jdynamic
from quantnet_torch import interop
from quantnet_torch.bench.benchmark import InferenceBenchmark
from quantnet_torch.core.config import Flags
from quantnet_torch.entry import entry
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.ops import linear as tlinear
from quantnet_torch.ops.conv import conv2d as tconv2d
from quantnet_torch.ops.layers import maxpool2d as tmaxpool2d
from quantnet_torch.quantize import common as tcommon
from quantnet_torch.quantize import dynamic as tdynamic
from quantnet_torch.quantize import fold as tfold

IMAGE = 16
BATCH = 2
CONVS = ["conv1", "conv2", "conv3", "conv4", "conv5", "conv6"]
# The input each captured layer sees is the previous conv's output (pooled
# after conv2, conv4 and conv6).
NEXT = dict(zip(CONVS, CONVS[1:] + ["fc1"]))


@pytest.fixture(scope="module")
def model():
    params, state = jconvnet.init(jax.random.PRNGKey(0), image_size=IMAGE)
    params_np, state_np = jax.tree.map(np.array, params), jax.tree.map(np.array, state)
    # Non-trivial BN statistics, so that folding does real work.
    r = np.random.default_rng(0)
    for name, st in state_np.items():
        c = st["mean"].shape[0]
        st["mean"][:] = 0.1 * r.standard_normal(c)
        st["var"][:] = 0.5 + r.random(c)
        params_np[name]["bn"]["gamma"][:] = 1 + 0.2 * r.standard_normal(c)
        params_np[name]["bn"]["beta"][:] = 0.1 * r.standard_normal(c)
    jq, jqs = jdynamic.quantize(
        jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, state_np)
    )
    x = np.random.default_rng(1).standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    return {
        "params_np": params_np,
        "state_np": state_np,
        "jq": jq,
        "jqs": jqs,
        "tq": interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu"),
        "x": x,
    }


def jit_unfused(fn, *args):
    """fn(*args) under jax.jit, compiled without XLA's fusion pass. XLA's CPU
    backend contracts a multiply and an add inside one fusion into an FMA
    (the epilogue's acc * scale + b), which the TPU does not do and the
    port's kernels do not do either; every other jit rewrite (the f32
    reciprocal for / 127 among them) stays."""
    compiled = jax.jit(fn).lower(*args).compile({"xla_disable_hlo_passes": "fusion"})
    return compiled(*args)


def _use_backends(monkeypatch, matmul, conv):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", matmul)
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", conv)


def _jax_forward(monkeypatch, m, matmul, conv):
    """The JAX forward under jit, as the JAX package runs it (bench, evaluator,
    serving): XLA then takes the activation scale's amax / 127 as a multiply
    by f32(1 / 127), which the port reproduces; the eager forward divides."""
    _use_backends(monkeypatch, matmul, conv)

    def forward(q, qs, x):
        capture = {}
        logits, _ = jconvnet.apply(q, qs, x, capture=capture)
        return logits, capture

    args = (m["jq"], m["jqs"], jnp.asarray(m["x"]))
    with pltpu.force_tpu_interpret_mode():
        logits, capture = jax.block_until_ready(jit_unfused(forward, *args))
    return np.asarray(logits), capture


def _port_conv_chain_matches(m, captured, flags):
    x = torch.from_numpy(m["x"])
    for name in CONVS:
        x = tconv2d(m["tq"][name], x, activation="relu", flags=flags)
        if name in ("conv2", "conv4", "conv6"):
            x = tmaxpool2d(x)
        ref = captured[NEXT[name]]
        assert x.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, name
        np.testing.assert_array_equal(
            x.float().numpy().reshape(ref.shape), np.asarray(ref.astype(jnp.float32)), err_msg=name
        )


def test_fold_and_dynamic_quantize_match_jax(model):
    """The port's own fold + quantize of the same fp32 params gives the JAX
    package's int8 weights. rsqrt may round differently in the last place in
    the two frameworks, which can move a weight across a rounding boundary:
    such ±1 steps are counted and must stay rare (none at this seed)."""
    tp, ts = interop.from_jax_params(model["params_np"], model["state_np"], device="cpu")
    tq, tqs = tdynamic.quantize(tp, ts)
    assert tqs == {} and set(tq) == set(model["jq"])
    off_by_one = total = 0
    for name, jl in model["jq"].items():
        tl = tq[name]
        d = np.abs(tl["w"].values.numpy().astype(np.int32) - np.asarray(jl["w"].values, np.int32))
        assert d.max() <= 1, name
        off_by_one += int((d == 1).sum())
        total += d.size
        np.testing.assert_allclose(tl["w"].scale.numpy(), np.asarray(jl["w"].scale), rtol=1e-6)
        np.testing.assert_allclose(tl["b"].numpy(), np.asarray(jl["b"]), rtol=1e-6, atol=1e-6)
        assert tl["aq"].handoff == jl["aq"].handoff
        assert "bn" not in tl
    assert off_by_one <= total * 1e-4, f"{off_by_one} of {total} weights differ by 1"


def test_whole_model_pallas_path(monkeypatch, model):
    """JAX with `int8_matmul_backend="pallas"`, `int8_conv_backend="im2col"`
    (both kernels in interpret mode) against the port's kernel path.

    conv1-conv6: the same bits. Logits: both feed fc1's fused kernel the bf16
    handoff of conv6, and the port takes the block scales and quotients on
    bf16 values as XLA does in the Pallas body; the rest is float order
    (measured at most 9.5e-7 at max|logit| 8.6 over three inputs; the bound
    was 2% of max|logit| while the port upcast fc1's input to f32). Fed the
    same f32 input, the two fc paths agree to float order as well."""
    ref, captured = _jax_forward(monkeypatch, model, "pallas", "im2col")
    _port_conv_chain_matches(model, captured, Flags())
    got, _ = tconvnet.apply(model["tq"], {}, torch.from_numpy(model["x"]))
    assert got.shape == (BATCH, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

    fc_in = np.asarray(captured["fc1"].astype(jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        h = jlinear.linear(model["jq"]["fc1"], jnp.asarray(fc_in), activation="relu")
        ref_f32 = np.asarray(jlinear.linear(model["jq"]["fc2"], h))
    got_f32 = tlinear.linear(model["tq"]["fc1"], torch.from_numpy(fc_in), activation="relu")
    got_f32 = tlinear.linear(model["tq"]["fc2"], got_f32)
    np.testing.assert_allclose(got_f32.numpy(), ref_f32, rtol=1e-5, atol=1e-4)


def test_whole_model_unfused_path_matches_xla(monkeypatch, model):
    """JAX's `xla` backend (exact int8 GEMMs and convs, per-row fc quant, bf16
    handoff everywhere) against the port's unfused path: every conv output is
    the same bits, and the logits agree to float order."""
    ref, captured = _jax_forward(monkeypatch, model, "xla", "xla")
    flags = Flags(dynamic_linear="unfused")
    _port_conv_chain_matches(model, captured, flags)
    got, _ = tconvnet.apply(model["tq"], {}, torch.from_numpy(model["x"]), flags=flags)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_fp32_model_and_fold_match_jax(model):
    """The fp32 forward with BN, and after folding, against the JAX package."""
    jp = jax.tree.map(jnp.asarray, model["params_np"])
    js = jax.tree.map(jnp.asarray, model["state_np"])
    ref, _ = jconvnet.apply(jp, js, jnp.asarray(model["x"]))
    tp, ts = interop.from_jax_params(model["params_np"], model["state_np"], device="cpu")
    got, _ = tconvnet.apply(tp, ts, torch.from_numpy(model["x"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    folded, fs = tfold.fold_model(tp, ts)
    got_f, _ = tconvnet.apply(folded, fs, torch.from_numpy(model["x"]))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_interop_round_trip():
    """JAX params -> numpy -> port -> forward, against the port's own quantize
    of the same fp32 params carried over.

    The JAX package quantizes under jit, where XLA turns `amax / 127` into a
    multiply by the f32 reciprocal, and the port's weight quantization does
    the same (quantnet_torch/quantize/common.py::quantize_weight). Folded by
    the JAX package, the two trees then hold the same bits and give the same
    logits. Folded by the port, XLA's and PyTorch's rsqrt part in the last
    place; an ulp in a weight can tip a bf16 handoff value, which can move a
    per-tensor activation scale and with it a whole layer's int8 grid:
    measured 1.5% of max|logit| at this seed, bound 5%."""
    from quantnet.quantize import fold as jfold

    params, state = jconvnet.init(jax.random.PRNGKey(0), image_size=IMAGE)
    jq, _ = jdynamic.quantize(params, state)
    folded, _ = jfold.fold_model_jit(params, state)
    carried = interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    )
    ref, _ = tconvnet.apply(carried, {}, x)

    own, _ = tdynamic.quantize(*interop.from_jax_params(
        jax.tree.map(np.asarray, folded), {}, device="cpu"))
    for name in own:
        assert torch.equal(own[name]["w"].values, carried[name]["w"].values), name
        assert torch.equal(own[name]["w"].scale, carried[name]["w"].scale), name
    got, _ = tconvnet.apply(own, {}, x)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())

    own_fold, _ = tdynamic.quantize(*interop.from_jax_params(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state), device="cpu"))
    got, _ = tconvnet.apply(own_fold, {}, x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=0.05 * ref.abs().max().item())


def test_init_matches_jax_shapes():
    jp, js = jconvnet.init(jax.random.PRNGKey(0))
    tp, ts = tconvnet.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(tp) == shapes(jp) and shapes(ts) == shapes(js)
    w = tp["conv6"]["w"]
    assert abs(w.std().item() - (2.0 / (9 * 256)) ** 0.5) < 2e-3  # Kaiming fan-in
    again, _ = tconvnet.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["fc1"]["w"], tp["fc1"]["w"])


def test_skip_layers_and_model_order():
    tp, ts = tconvnet.init(torch.Generator().manual_seed(0), image_size=8, device="cpu")
    # Reversed dict order must not change which layers are first and last.
    rev = dict(reversed(list(tp.items())))
    assert tcommon.first_layer_path(rev) == "conv1"
    assert tcommon.last_layer_path(rev) == "fc2"
    q, _ = tdynamic.quantize(tp, ts, skip_first_layer=True, skip_last_layer=True)
    assert isinstance(q["conv1"]["w"], torch.Tensor) and "aq" not in q["conv1"]
    assert isinstance(q["fc2"]["w"], torch.Tensor)
    assert q["fc1"]["aq"].handoff == "bfloat16"
    logits, _ = tconvnet.apply(q, {}, torch.zeros((1, 8, 8, 3)))
    assert logits.shape == (1, 10)


def test_entry_runs_on_cpu_when_asked():
    fn, args = entry(device="cpu", batch_size=2)
    logits = fn(*args)
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract does not apply")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        tconvnet.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.from_jax_qparams({})
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceBenchmark(iters=1).measure(tconvnet.apply, {}, {}, 1)
