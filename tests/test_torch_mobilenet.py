"""The port's MobileNetV2 against the JAX package's, on the CPU.

Width 1.0 (and 0.5, 0.25), 10 classes, batch 2 at 64x64 as
tests/test_mobilenet.py runs it, and at 32x32, where the last feature map is
1x1 and the global average pool takes one value per channel. Weights come
from a seeded init with non-trivial BN statistics, as numpy handed to both
packages (the JAX side as arrays, the port's through
quantnet_torch.interop); inputs are numpy from a seed.

Bounds, with their reasons:
- int8 schemes (dynamic, static, W4A8) at 32x32 (calibrated at 64x64):
  bit-equal, every int8 layer input and the logits. The int8 products are exact in both packages
  (the JAX side on its exact `xla` backend), the epilogues are the same f32
  operations in the same order, and the depthwise conv's accumulator is nine
  exact products. The dynamic forward runs jitted, as the JAX package runs
  it (jit turns the activation scale's division into a multiply), compiled
  without XLA's fusion pass (`jit_unfused`: no FMA contraction) and without
  XLA's excess precision (`jit_exact`): the CPU backend computes bf16
  arithmetic in f32 and by default drops the bf16 rounding between ops, so
  a residual add of two bf16 handoffs would read the project conv's f32
  output; the TPU adds in bf16, and so does the port (ROADMAP Queue 3).
- float schemes (fp32, weight-only): f32 convs against XLA's, summed in
  other orders: within 1e-4 x max|logit|, the bound the convnet's float
  schemes use (tests/test_torch_artifacts.py).
- bf16: within 1e-2 x max|logit| (measured 4.8e-3 at this seed). Every one
  of the 53 layers rounds its input to bf16 (2^-8 relative); an f32 sum in
  another order moves a value across a bf16 rounding edge now and then, and
  the step travels through the depth that the convnet's eight layers do not
  have.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import config as jcfg
from quantnet.models import mobilenet as jmobilenet
from quantnet.quantize import bf16 as jbf16
from quantnet.quantize import dynamic as jdynamic
from quantnet.quantize import fold as jfold
from quantnet.quantize import static as jstatic
from quantnet.quantize import weight_only as jweight_only
from quantnet_torch import interop
from quantnet_torch.core.config import Flags
from quantnet_torch.core.types import ActQuant, QTensor
from quantnet_torch.models import mobilenet as tmobilenet
from quantnet_torch.ops import conv as tconv
from quantnet_torch.ops.depthwise_conv import depthwise_acc_plain, depthwise_conv
from quantnet_torch.ops.int8_matmul import activation
from quantnet_torch.quantize import common as tcommon
from quantnet_torch.quantize import fold as tfold
from quantnet_torch.quantize import static as tstatic
from test_torch_convnet import jit_unfused

BATCH = 2
CLASSES = 10
FLOAT_TOL = 1e-4


def _perturb_bn(params, state, r):
    for key, st in state.items():
        if "mean" in st:
            c = st["mean"].shape[0]
            st["mean"][:] = 0.1 * r.standard_normal(c)
            st["var"][:] = 0.5 + r.random(c)
            params[key]["bn"]["gamma"][:] = 1 + 0.2 * r.standard_normal(c)
            params[key]["bn"]["beta"][:] = 0.1 * r.standard_normal(c)
        else:
            _perturb_bn(params[key], st, r)


def jit_exact(fn, *args):
    """fn(*args) jitted without XLA's fusion pass (as `jit_unfused`) and
    without excess precision: bf16 values are rounded to bf16 between ops,
    as on the TPU (see the module docstring)."""
    opts = {"xla_disable_hlo_passes": "fusion", "xla_allow_excess_precision": False}
    return jax.jit(fn).lower(*args).compile(opts)(*args)


def _images(size, seed):
    return np.random.default_rng(seed).standard_normal((BATCH, size, size, 3)).astype(np.float32)


def _numpy_init(seed, width=1.0):
    """Weights and BN statistics as numpy, from the port's seeded init (the
    two inits' trees have the same shapes: test_init_and_widths_match_jax);
    both packages then take the same arrays."""
    tp, ts = tmobilenet.init(torch.Generator().manual_seed(seed), num_classes=CLASSES,
                             width_mult=width, device="cpu")
    as_np = lambda t: jax.tree.map(lambda a: a.numpy().copy(), t)  # noqa: E731
    return as_np(tp), as_np(ts)


def _jax_logits(params, state, x):
    """The JAX forward's logits, jitted as `jit_exact` compiles it."""
    return jit_exact(lambda p, s, xx: jmobilenet.apply(p, s, xx)[0], params, state, jnp.asarray(x))


@pytest.fixture(scope="module")
def model():
    pn, sn = _numpy_init(0)
    _perturb_bn(pn, sn, np.random.default_rng(0))
    jp, js = jax.tree.map(jnp.asarray, pn), jax.tree.map(jnp.asarray, sn)
    tp, ts = interop.from_jax_params(pn, sn, device="cpu")
    return {"jp": jp, "js": js, "tp": tp, "ts": ts, "x64": _images(64, 1), "x32": _images(32, 2)}


@pytest.fixture(autouse=True)
def xla(monkeypatch):
    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "xla")
    monkeypatch.setattr(jcfg.flags, "int8_conv_backend", "xla")


def _close(got: torch.Tensor, ref, tol):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("width", [1.0, 0.5, 0.25])
def test_init_and_widths_match_jax(width):
    assert tmobilenet.block_widths(width) == jmobilenet.block_widths(width)
    jp, js = jax.eval_shape(lambda: jmobilenet.init(jax.random.PRNGKey(0), 10, width))
    tp, ts = tmobilenet.init(torch.Generator().manual_seed(0), num_classes=10, width_mult=width,
                             device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(tp) == shapes(jp) and shapes(ts) == shapes(js)


def test_layer_order_gives_stem_and_fc(model):
    """The port's first / last layer resolution on MobileNetV2, as
    tests/test_quantize_core.py:210-220 holds it for the JAX package: the
    stem first and the fc last, in dict order and in sorted-key order (where
    'block0' < 'conv_head' < 'conv_stem' < 'fc')."""
    folded, _ = tfold.fold_model(model["tp"], model["ts"])
    paths = tcommon.layer_paths(folded)
    assert len(paths) == 53 and "block7/dw" in paths and "block16/project" in paths
    for tree in (folded, {k: folded[k] for k in sorted(folded)}):
        assert tcommon.first_layer_path(tree) == "conv_stem"
        assert tcommon.last_layer_path(tree) == "fc"
    assert tcommon._model_order_key("block2/dw") < tcommon._model_order_key("block10/dw")
    assert tcommon._model_order_key("conv_head") < tcommon._model_order_key("fc")


@pytest.mark.parametrize("folded", [False, True])
def test_fp32_matches_jax(model, folded):
    jp, js, tp, ts = model["jp"], model["js"], model["tp"], model["ts"]
    if folded:
        jp, js = jfold.fold_model_jit(jp, js)
        tp, ts = interop.from_jax_params(jax.tree.map(np.asarray, jp), {}, device="cpu")
    ref = _jax_logits(jp, js, model["x64"])
    got, _ = tmobilenet.apply(tp, ts, torch.from_numpy(model["x64"]))
    _close(got, ref, FLOAT_TOL)


def _compare_int8(jq, x, flags=Flags()):
    """JAX forward (capture, `jit_exact`) vs the port's on the carried-over
    tree: every captured layer input of the same dtype, int8 ones bit-equal;
    the logits."""
    tcap = {}

    def jforward(q, xx):
        cap = {}
        logits, _ = jmobilenet.apply(q, {}, xx, capture=cap)
        return logits, cap

    ref, jcap = jit_exact(jforward, jq, jnp.asarray(x))
    tq = interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu")
    got, _ = tmobilenet.apply(tq, {}, torch.from_numpy(x), capture=tcap, flags=flags)
    assert set(tcap) == set(jcap)
    n_int8 = 0
    for key, ref_in in jcap.items():
        ref_in = np.asarray(ref_in)
        assert str(tcap[key].dtype).rsplit(".", 1)[-1] == str(ref_in.dtype), key
        if ref_in.dtype == np.int8:
            np.testing.assert_array_equal(tcap[key].numpy(), ref_in, err_msg=key)
            n_int8 += 1
    return got, np.asarray(ref), tq, n_int8, jcap


@pytest.fixture(scope="module")
def static_trees(model):
    """The JAX package's static trees (min-max calibration on the 64x64
    batch, int8 stem and fp32 stem) and its W4A8 tree (g128: the fc's K of
    1280 in ten groups)."""
    jf, _ = jfold.fold_model_jit(model["jp"], model["js"])
    act = jstatic.calibrate(jmobilenet.apply, jf, {}, [(jnp.asarray(model["x64"]), None)])
    out = {sf: jstatic.bake(jf, {}, act, skip_first_layer=sf)[0] for sf in (False, True)}
    out["w4a8"] = jstatic.bake(jf, {}, act, weight_bits=4, weight_group_size=128)[0]
    out["jf"], out["act"] = jf, act
    return out


@pytest.mark.parametrize("skip_first_layer", [False, True])
def test_static_matches_jax(model, static_trees, skip_first_layer):
    got, ref, tq, n_int8, _ = _compare_int8(static_trees[skip_first_layer], model["x32"])
    # Every conv but the stem receives int8, already quantized by its
    # producer (an fp32 stem hands int8 on too); the stem takes the images and
    # the fc the f32 average pool.
    assert n_int8 == 51
    assert isinstance(tq["block3"]["dw"]["aq"], ActQuant) and tq["block3"]["dw"]["w"].values.shape == (3, 3, 1, 144)
    assert tq["block3"]["dw"]["w"].scale.shape[-1] == 144  # per channel
    np.testing.assert_array_equal(got.numpy(), ref)


def test_w4a8_matches_jax(model, static_trees):
    """MobileNetV2 W4A8: 4-bit per-channel convs (the depthwise ones too)
    and the fc grouped (g128) through the grouped-K product."""
    got, ref, tq, n_int8, _ = _compare_int8(static_trees["w4a8"], model["x32"])
    assert tq["fc"]["w"].group_size == 128 and tq["fc"]["wsum"].shape == (10, CLASSES)
    assert tq["block5"]["dw"]["w"].bits == 4 and n_int8 == 51
    np.testing.assert_array_equal(got.numpy(), ref)


def test_static_bake_matches_jax(static_trees):
    """The port's bake of the JAX-folded params from the same statistics is
    the JAX package's, leaf for leaf, depthwise weights and their per-channel
    scales included."""
    tf = interop.from_jax_params(jax.tree.map(np.asarray, static_trees["jf"]), {}, device="cpu")[0]
    act = {k: (torch.from_numpy(np.array(s)), torch.from_numpy(np.array(z)))
           for k, (s, z) in static_trees["act"].items()}
    got, _ = tstatic.bake(tf, {}, act)
    ref = interop.from_jax_qparams(jax.tree.map(np.asarray, static_trees[False]), device="cpu")
    for path in tcommon.layer_paths(ref):
        a, b = got, ref
        for part in path.split("/"):
            a, b = a[part], b[part]
        assert torch.equal(a["w"].values, b["w"].values) and torch.equal(a["w"].scale, b["w"].scale), path
        assert torch.equal(a["wsum"], b["wsum"]) and torch.equal(a["aq"].scale, b["aq"].scale), path


def test_dynamic_matches_jax(model):
    """Dynamic INT8 with the bf16 handoff, at 32x32: per-tensor quantized
    convs (the depthwise ones through the depthwise kernel's plain version)
    and the fc quantized per row, as the JAX package's `xla` backend: bit-equal."""
    jq, _ = jdynamic.quantize(model["jp"], model["js"], last_layer_name="fc")
    got, ref, _, _, _ = _compare_int8(jq, model["x32"], Flags(dynamic_linear="unfused"))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_dynamic_fused_fc_matches_jax(monkeypatch, model):
    """The dynamic fc through the fused dynamic GEMM (the JAX `pallas`
    backend, its kernel in interpret mode) at K = 1280, two whole K-blocks of
    512 and one zero-padded: the fc's bf16 input as the JAX forward makes it,
    through both layers, bit-equal. The fused kernel's bf16 block scale
    follows XLA's excess precision (ops/fused_dynamic_matmul.py), so this
    reference runs as `jit_unfused` does, with it; the whole forward, where
    `jit_exact` turns it off for the backbone's residual adds, agrees within
    1e-2 x max|logit| (measured 2.5e-3)."""
    from jax.experimental.pallas import tpu as pltpu
    from quantnet.ops import linear as jlinear

    monkeypatch.setattr(jcfg.flags, "int8_matmul_backend", "pallas")
    jq, _ = jdynamic.quantize(model["jp"], model["js"], last_layer_name="fc")
    with pltpu.force_tpu_interpret_mode():
        got, ref, tq, _, jcap = _compare_int8(jq, model["x32"])
        fc_in = jcap["fc"]
        assert fc_in.dtype == jnp.bfloat16 and fc_in.shape == (BATCH, 1280)
        fc_ref = jax.block_until_ready(jit_unfused(lambda l, xx: jlinear.linear(l, xx), jq["fc"], fc_in))
    fc_got = torch.from_numpy(np.asarray(fc_in.astype(jnp.float32))).to(torch.bfloat16)
    np.testing.assert_array_equal(tlinear_fc(tq, fc_got).numpy(), np.asarray(fc_ref))
    _close(got, ref, 1e-2)


def tlinear_fc(tq, x):
    from quantnet_torch.ops.linear import linear

    return linear(tq["fc"], x)


@pytest.mark.parametrize("scheme", ["weight_only", "weight_only_int4", "bf16"])
def test_float_schemes_match_jax(model, scheme):
    jp, js = model["jp"], model["js"]
    if scheme == "bf16":
        jq, _ = jbf16.quantize(jp, js)
    else:
        bits = 4 if scheme.endswith("int4") else 8
        jq, _ = jweight_only.quantize(jp, js, bits=bits, group_size=128 if bits == 4 else None,
                                      last_layer_name="fc")
        assert isinstance(jq["block3"]["dw"]["w"].values, jax.Array)
    ref = _jax_logits(jq, {}, model["x64"])
    tq = interop.from_jax_qparams(jax.tree.map(np.asarray, jq), device="cpu")
    if scheme != "bf16":
        assert isinstance(tq["block3"]["dw"]["w"], QTensor)
    got, _ = tmobilenet.apply(tq, {}, torch.from_numpy(model["x64"]))
    _close(got, ref, FLOAT_TOL if scheme != "bf16" else 1e-2)


def test_width_025_mirrors_the_block0_residual_quirk():
    """At width 0.25 the stem and block0 are both 8 wide, so torchvision adds
    block0's residual; the JAX package's _block_cin reads the depthwise
    kernel's I axis (1) for a t=1 block and never does. The port mirrors it
    (ROADMAP Queue 3): its forward is the JAX package's."""
    pn, sn = _numpy_init(5, width=0.25)
    params, state = jax.tree.map(jnp.asarray, pn), jax.tree.map(jnp.asarray, sn)
    tp, ts = interop.from_jax_params(pn, sn, device="cpu")
    assert tmobilenet.block_widths(0.25)[0] == tmobilenet.block_widths(0.25)[2][0][2] == 8
    assert tmobilenet._block_cin(tp["block0"]) == jmobilenet._block_cin(params["block0"]) == 1
    x = _images(32, 6)
    ref = _jax_logits(params, state, x)
    got, _ = tmobilenet.apply(tp, ts, torch.from_numpy(x))
    _close(got, ref, FLOAT_TOL)


# (stride, pads, channels, pad value): SAME at stride 1 and 2 (XLA pads
# (0, 1) at stride 2 on an even size), torch's (1, 1), a channel count off
# the kernel's 16-channel vector.
DW_CASES = [(1, ((1, 1), (1, 1)), 32, 0), (2, ((0, 1), (0, 1)), 48, -5), (2, ((1, 1), (1, 1)), 16, 3),
            (1, ((1, 1), (1, 1)), 40, -128), (2, ((0, 1), (0, 1)), 24, 0)]


@pytest.mark.parametrize("stride,pads,c,pad_value", DW_CASES)
def test_depthwise_plain_matches_lax(stride, pads, c, pad_value):
    """The depthwise kernel's plain accumulator against
    lax.conv_general_dilated with feature_group_count = C in int32, exact."""
    r = np.random.default_rng(c)
    x = r.integers(-128, 128, (2, 10, 9, c)).astype(np.int8)
    w = r.integers(-127, 128, (3, 3, 1, c)).astype(np.int8)
    (pt, pb), (pl, pr) = pads
    xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)), constant_values=pad_value)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(xp), jnp.asarray(w), (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=c,
        preferred_element_type=jnp.int32)
    got = depthwise_acc_plain(torch.from_numpy(x), torch.from_numpy(w), stride, pads, pad_value)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(depthwise_conv(torch.from_numpy(x), torch.from_numpy(w), stride, pads,
                                      pad_value), got)


@pytest.mark.parametrize("scheme,store", [("static", "int8"), ("static", "f32"),
                                          ("dynamic", "bf16"), ("dynamic", "f32")])
def test_depthwise_conv_layer_matches_jax(scheme, store):
    """A depthwise int8 conv layer with relu6, stride 2, SAME, against the
    JAX conv2d with groups = C: static (zero-point pad, - zp * wsum, the int8
    handoff or f32) and dynamic (per-tensor scale, the bf16 handoff or f32)."""
    from quantnet.core.quantize import quantize_symmetric
    from quantnet.core.types import ActQuant as JActQuant
    from quantnet.core.types import DynamicActQuant as JDynamicActQuant
    from quantnet.ops import conv as jconv
    from quantnet.quantize.common import weight_colsum

    r = np.random.default_rng(11)
    c = 48
    w = jnp.asarray((r.standard_normal((3, 3, 1, c)) * 0.3).astype(np.float32))
    jl = {"w": quantize_symmetric(w, axis=3), "b": jnp.asarray(r.standard_normal(c).astype(np.float32))}
    if scheme == "static":
        jl["aq"] = JActQuant(scale=jnp.float32(0.031), zero_point=jnp.int32(-11))
        jl["wsum"] = weight_colsum(jl["w"])
        x = r.integers(-128, 128, (2, 10, 10, c)).astype(np.int8)
    else:
        jl["aq"] = JDynamicActQuant(handoff="bfloat16" if store == "bf16" else None)
        x = (r.standard_normal((2, 10, 10, c)) * 2).astype(np.float32)
    jout = JActQuant(scale=jnp.float32(0.023), zero_point=jnp.int32(-128)) if store == "int8" else None
    tout = ActQuant(torch.tensor(0.023), torch.tensor(-128, dtype=torch.int32)) if store == "int8" else None
    ref = jit_unfused(lambda l, xx: jconv.conv2d(l, xx, stride=2, activation="relu6", groups=c,
                                                 out_quant=jout), jl, jnp.asarray(x))
    tl = interop.from_jax_qparams({"l": jax.tree.map(np.asarray, jl)}, device="cpu")["l"]
    got = tconv.conv2d(tl, torch.from_numpy(x), stride=2, activation="relu6", groups=c, out_quant=tout)
    assert str(got.dtype).rsplit(".", 1)[-1] == str(np.asarray(ref).dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_relu6_bits_and_grouped_guard():
    """relu6 as XLA clamps, jitted: -0 gives +0 and NaN passes; a grouped
    conv that is not depthwise raises, naming the case."""
    v = np.array([-0.0, 0.0, -1.5, 3.25, 6.0, 7.0, np.inf, -np.inf, np.nan], np.float32)
    ref = np.asarray(jax.jit(lambda y: jnp.clip(y, 0.0, 6.0))(jnp.asarray(v)))
    got = activation(torch.from_numpy(v), "relu6").numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    layer = {"w": torch.zeros((3, 3, 2, 8))}
    with pytest.raises(NotImplementedError, match="other than depthwise"):
        tconv.conv2d(layer, torch.zeros((1, 6, 6, 8)), groups=4)


def test_trained_mnv2_artifact_matches_jax():
    """The tracked trained MobileNetV2 (runs/r5_mnv2_224, 20 classes, BN not
    folded) loaded by both packages, 4 images at 224x224: logits within
    1e-4 x max|logit|, the same argmax."""
    import pathlib

    from quantnet.train import checkpoint as jckpt
    from quantnet_torch.train import checkpoint as tckpt

    path = str(pathlib.Path(__file__).resolve().parent.parent / "runs" / "r5_mnv2_224" / "saved" / "fp32")
    jt, meta = jckpt.load_artifact(path)
    tt, tmeta = tckpt.load_artifact(path, device="cpu")
    assert tmeta == meta and meta["model"] == "mobilenetv2"
    x = np.random.default_rng(7).standard_normal((4, 224, 224, 3)).astype(np.float32)
    ref = _jax_logits(jt["params"], jt["state"], x)
    got, _ = tmobilenet.apply(tt["params"], tt["state"], torch.from_numpy(x))
    assert got.shape == (4, 20)
    _close(got, ref, FLOAT_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(1), np.asarray(ref).argmax(1))


def test_importer_matches_jax_and_torch():
    """mobilenet_from_torch on a torchvision-layout state dict: the JAX
    importer's tree leaf for leaf, and the imported tree's forward
    (torch_pad) against the torch module's own, within 2e-3 as the JAX
    package's importer test holds it (tests/test_torch_import.py)."""
    from quantnet.models.torch_import import mobilenet_from_torch as j_import
    from quantnet_torch.models.torch_import import mobilenet_from_torch as t_import
    from test_torch_import import _randomize_bn_stats, _TorchMobileNetV2

    torch.manual_seed(3)
    m = _TorchMobileNetV2().eval()
    with torch.no_grad():
        _randomize_bn_stats(m, seed=3)
    sd = m.state_dict()
    tp, ts = t_import(sd, device="cpu")
    jp, js = j_import(sd)
    ref_tree = interop.from_jax_params(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js),
                                       device="cpu")
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    for (pa, a), (pb, b) in zip(flat((tp, ts)), flat(ref_tree)):
        assert pa == pb and torch.equal(a, b), pa
    x = np.random.default_rng(3).normal(size=(2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        ref = m(torch.from_numpy(x)).numpy()
    apply = functools.partial(tmobilenet.apply, torch_pad=True)
    got, _ = apply(tp, ts, torch.from_numpy(x.transpose(0, 2, 3, 1).copy()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)


def test_macs_count_depthwise_per_group(model):
    """ops/macs.py counts a depthwise conv as kh*kw*(Cin/groups)*Cout MACs
    per output pixel (in-bounds taps), so mfu stays true for MobileNetV2.
    Held against the JAX package's analytic count of the same forward's
    jaxpr, conv by conv, where the grouped convs are taken times their
    feature_group_count: the JAX count divides by it once more than the
    kernel's I axis (Cin/groups already) needs, and so counts a depthwise
    conv C times too low (ROADMAP Queue 3); the other 36 layers' counts are
    the JAX package's."""
    from quantnet.bench.benchmark import _flops_of_eqn
    from quantnet_torch.bench.benchmark import estimate_flops

    def flops(jaxpr):
        total = 0.0
        for eqn in jaxpr.eqns:
            f = _flops_of_eqn(eqn)
            if eqn.primitive.name == "conv_general_dilated":
                f *= eqn.params["feature_group_count"]
            total += f
            for p in ("jaxpr", "call_jaxpr"):
                sub = eqn.params.get(p)
                if sub is not None:
                    total += flops(getattr(sub, "jaxpr", sub))
        return total

    jf, _ = jfold.fold_model_jit(model["jp"], model["js"])
    fn = lambda p, xx: jmobilenet.apply(p, {}, xx)[0]  # noqa: E731
    ref = flops(jax.make_jaxpr(fn)(jf, jnp.asarray(model["x32"])).jaxpr)
    tf = interop.from_jax_params(jax.tree.map(np.asarray, jf), {}, device="cpu")[0]
    assert estimate_flops(tmobilenet.apply, tf, {}, torch.from_numpy(model["x32"])) == ref


@pytest.mark.parametrize("scale,zp", [(0.0517, -3), (0.023, -128), (6.0 / 127, 0), (2.0**-7, 5), (0.9, 120)])
def test_relu6_folds_into_the_int8_clamp(scale, zp):
    """The kernels' int8 store takes relu6's upper clip in its clamp
    (csrc/epilogue.cuh): clamp(rint(relu(y) / s) + zp, -128, min(127,
    rint(6 / s) + zp)) has the bits of quantize_affine(relu6(y)), as
    division, rounding and the zero point's add are monotone. Held on random
    magnitudes, on values within 16 ulps of every half-integer multiple of s
    around 6, and on infinities (a NaN's int8 is the cast's, not the
    arithmetic's, and is left out)."""
    from quantnet_torch.core.quantize import quantize_affine
    from quantnet_torch.ops.int8_matmul import requantize_cases

    s, z = torch.tensor(scale), torch.tensor(zp, dtype=torch.int32)
    y = torch.cat([requantize_cases(scale, "cpu"),
                   torch.tensor([6.0, float("inf"), -float("inf"), -0.0]),
                   ((torch.arange(-20, 21, dtype=torch.float64) / 2 * scale + 6.0).float().view(torch.int32)[:, None]
                    + torch.arange(-16, 17, dtype=torch.int32)).view(torch.float32).reshape(-1)])
    want = quantize_affine(activation(y, "relu6"), s, z)
    q6 = torch.round(torch.tensor(6.0) / s) + zp
    folded = torch.round(activation(y, "relu") / s) + zp
    got = torch.minimum(torch.clamp(folded, -128, 127), torch.clamp(q6, max=127.0)).to(torch.int8)
    assert torch.equal(got, want)
