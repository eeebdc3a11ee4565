"""The port's training layers against the JAX package: train-mode batchnorm,
dropout, max pooling's gradient, the STE fake quantizers and the three
models' train-mode forward and gradients.

Bit-equal where both packages compute the same floats in the same order
(the STE forwards, dropout from the same mask, pooling, the BN formula from
the same batch statistics); otherwise to stated tolerances: a batch mean is a
sum, and torch and XLA's CPU backend sum in other orders, as their f32 convs
do (ROADMAP Queue 3 items 1 and 13).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core import quantize as jq
from quantnet.models import convnet as jconvnet
from quantnet.models import mobilenet as jmobilenet
from quantnet.models import resnet as jresnet
from quantnet.ops import layers as jlayers
from quantnet_torch.core import quantize as tq
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.models import mobilenet as tmobilenet
from quantnet_torch.models import resnet as tresnet
from quantnet_torch.ops import layers as tlayers
from quantnet_torch.ops.int8_matmul import activation as tactivation
from quantnet_torch.train.trainer import clone_tree, cross_entropy, tensor_leaves

from test_torch_convnet import jit_unfused


def _bn_inputs(shape, seed):
    r = np.random.default_rng(seed)
    c = shape[-1]
    x = (r.standard_normal(shape) * 3 + 1).astype(np.float32)
    p = {"gamma": r.standard_normal(c).astype(np.float32), "beta": r.standard_normal(c).astype(np.float32)}
    s = {"mean": r.standard_normal(c).astype(np.float32),
         "var": r.uniform(0.5, 2, c).astype(np.float32)}
    return x, p, s


@pytest.mark.parametrize("shape", [(4, 8, 8, 32), (16, 64), (2, 5, 7, 3)])
def test_batchnorm_train_matches_jax(shape):
    """The new running statistics and the output against the jitted JAX BN:
    within a few ulps (the batch mean and variance are sums, in other
    orders); bit-equal where every sum is exact (small integers and their
    negatives over a power of two rows: any order gives the same floats), the
    output then within rsqrt's ulp (Queue 3 item 2)."""
    x, p, s = _bn_inputs(shape, 0)
    half = np.random.default_rng(1).integers(-8, 9, (2, 8, 8, shape[-1])).astype(np.float32)
    exact = np.concatenate([half, -half])
    for inp, tol in ((x, 2e-6), (exact, 0.0)):
        jy, jns = jit_unfused(lambda p_, s_, x_: jlayers.batchnorm_apply(p_, s_, x_, train=True),
                              p, s, inp)
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        ts = {k: torch.from_numpy(v) for k, v in s.items()}
        ty, tns = tlayers.batchnorm_train(tp, ts, torch.from_numpy(inp))
        for k in ("mean", "var"):
            np.testing.assert_allclose(tns[k].numpy(), np.asarray(jns[k]), rtol=tol, atol=tol / 10)
        out_tol = 4e-7 if tol == 0.0 else 2e-5
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=out_tol, atol=out_tol)


def test_batchnorm_train_gradient_matches_jax():
    x, p, s = _bn_inputs((4, 6, 6, 16), 1)
    w = np.random.default_rng(2).standard_normal((4, 6, 6, 16)).astype(np.float32)

    def jloss(p_, x_):
        return jnp.sum(jlayers.batchnorm_apply(p_, s, x_, train=True)[0] * w)

    jg = jax.grad(jloss, argnums=(0, 1))(p, x)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = tlayers.batchnorm_train(tp, {k: torch.from_numpy(v) for k, v in s.items()}, tx)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), rtol=1e-4, atol=1e-5)
    for k in ("gamma", "beta"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rate", [0.25, 0.5, 0.2])
def test_dropout_with_injected_mask_is_bit_equal(rate):
    r = np.random.default_rng(3)
    x = r.standard_normal((8, 33)).astype(np.float32)
    mask = r.random((8, 33)) < 1 - rate
    keep = 1.0 - rate
    want = jit_unfused(lambda v, m: jnp.where(m, v / keep, 0.0), x, mask)
    got = tlayers.dropout(torch.from_numpy(x), rate, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dropout_draws_from_the_generator():
    x = torch.ones(64, 256)
    assert tlayers.dropout(x, 0.5) is x  # no generator, no mask: the identity
    a = tlayers.dropout(x, 0.25, torch.Generator().manual_seed(5))
    b = tlayers.dropout(x, 0.25, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    assert torch.equal(a[a != 0], torch.full_like(a[a != 0], np.float32(1) * np.float32(1 / 0.75)))


def test_clip_gradient_is_half_on_the_boundary():
    """jnp.clip splits the gradient at lo and hi; the port's STE and relu6
    give the same 0.5 there (torch.clamp would give 1)."""
    scale, zp = 0.05, -128  # after a relu: lo = 0 exactly
    lo = (jq.INT8_MIN - zp) * np.float32(scale)
    hi = float(np.float32(jq.INT8_MAX - zp) * np.float32(scale))
    x = np.array([lo, 0.3, hi, -1.0, hi + 1.0, 0.0, 1e-9], np.float32)
    jg = jax.grad(lambda v: jnp.sum(jq.fake_quant_act_ste(v, scale, zp) * 3.0))(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    (tq.fake_quant_act_ste(tx, scale, zp) * 3.0).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    assert tx.grad[0] == 1.5 and tx.grad[2] == 1.5
    y = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    jg6 = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 6.0)))(y)
    ty = torch.from_numpy(y).requires_grad_(True)
    tactivation(ty, "relu6").sum().backward()
    np.testing.assert_array_equal(ty.grad.numpy(), np.asarray(jg6))


@pytest.mark.parametrize("pool", ["2x2", "3x3s2"])
def test_maxpool_gradient_goes_to_the_first_maximum(pool):
    """Ties (quantized activations have many) send the whole gradient to a
    window's first maximum in both packages; the forward is the inference
    path's, bit for bit."""
    r = np.random.default_rng(4)
    x = r.integers(-2, 3, (2, 8, 8, 5)).astype(np.float32)  # many ties
    w = r.standard_normal((2, 4, 4, 5)).astype(np.float32)
    jpool = jlayers.maxpool2d if pool == "2x2" else jresnet._maxpool_3x3_s2
    tpool = tlayers.maxpool2d if pool == "2x2" else tresnet._maxpool_3x3_s2
    jg = jax.grad(lambda v: jnp.sum(jpool(v) * w))(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tpool(tx)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(y.detach().numpy(), tpool(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jpool(x)))


@pytest.mark.parametrize("scale,zp", [(0.05, -128), (0.0371, -17), (1e-3, 5), (0.2, 127)])
def test_act_ste_forward_bit_equal(scale, zp):
    x = (np.random.default_rng(5).standard_normal(4096) * 4).astype(np.float32)
    x[:3] = [(jq.INT8_MIN - zp) * np.float32(scale), 0.0, (jq.INT8_MAX - zp) * np.float32(scale)]
    want = [jq.fake_quant_act_ste(jnp.asarray(x), scale, zp),
            jit_unfused(lambda v: jq.fake_quant_act_ste(v, scale, zp), x)]
    got = tq.fake_quant_act_ste(torch.from_numpy(x), scale, zp).numpy()
    for w in want:
        np.testing.assert_array_equal(got, np.asarray(w))


@pytest.mark.parametrize("shape,per_channel,bits,group", [
    ((3, 3, 16, 8), True, 8, None), ((3, 3, 16, 8), False, 8, None), ((256, 32), True, 4, 128),
    ((3, 3, 4, 8), True, 4, 128), ((96, 10), True, 4, 128), ((3, 3, 1, 24), True, 8, None),
])
def test_weight_ste_forward_bit_equal_and_gradient_identity(shape, per_channel, bits, group):
    w = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = jit_unfused(lambda v: jq.fake_quant_weight_ste(v, per_channel, bits=bits, group_size=group), w)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tq.fake_quant_weight_ste(tw, per_channel, bits, group)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * 2.0).sum().backward()
    np.testing.assert_array_equal(tw.grad.numpy(), np.full(shape, 2.0, np.float32))


# ---------------------------------------------------------------------------
# The models' train mode
# ---------------------------------------------------------------------------


def _as_np(tree):
    return jax.tree.map(lambda a: a.detach().numpy().copy(), tree)


def _models():
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    return {
        "convnet": (tconvnet, jconvnet, lambda: tconvnet.init(g(), image_size=16, device="cpu"), {}),
        "resnet18": (tresnet, jresnet,
                     lambda: tresnet.init(g(), num_classes=10, depth=18, zero_init_residual=True,
                                          device="cpu"), {}),
        "mobilenetv2_0.25": (tmobilenet, jmobilenet,
                             lambda: tmobilenet.init(g(), num_classes=10, width_mult=0.25, device="cpu"),
                             {}),
    }


@pytest.mark.parametrize("name", ["convnet", "resnet18", "mobilenetv2_0.25"])
def test_train_forward_and_gradients_match_jax(name):
    """train=True without an rng / generator (no dropout): the loss, every
    parameter's gradient and the new BN statistics against jax.value_and_grad
    of the JAX package's train-mode apply, from the same weights and batch."""
    tmod, jmod, init, _ = _models()[name]
    tp, ts = init()
    # MobileNetV2 at 64x64: its last stages then normalize over 16 values a
    # channel (at 32x32, 4: so ill-conditioned that rounding noise grows to
    # 1e-3 of the gradient).
    size = {"convnet": 16, "resnet18": 32}.get(name, 64)
    r = np.random.default_rng(7)
    x = r.standard_normal((4, size, size, 3)).astype(np.float32)
    labels = r.integers(0, 10, 4)
    pnp, snp = _as_np(tp), _as_np(ts)

    def jloss(p):
        logits, ns = jmod.apply(p, snp, jnp.asarray(x), train=True)
        onehot = jax.nn.one_hot(labels, 10)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1)), ns

    (jl, jns), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(pnp)
    tp = clone_tree(tp, requires_grad=True)
    logits, tns = tmod.apply(tp, ts, torch.from_numpy(x), train=True)
    loss = cross_entropy(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, tensor_leaves(tp))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    # To the largest gradient: a conv bias before train-mode BN has a zero
    # gradient, which both packages give as rounding noise (1e-7).
    gscale = max(np.abs(np.asarray(g)).max() for g in jleaves)
    for tg, jg_ in zip(grads, jleaves):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg_), rtol=1e-3, atol=5e-5 * gscale)
    for tv, jv in zip(tensor_leaves(tns), jax.tree.leaves(jns)):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)
    assert jax.tree.structure(_as_np(tns)) == jax.tree.structure(jns)
    # The caller's state is left as it was.
    for a, b in zip(tensor_leaves(ts), jax.tree.leaves(snp)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_inference_forward_has_no_autograd_and_dropout_needs_a_generator():
    tp, ts = tconvnet.init(torch.Generator().manual_seed(0), image_size=16, device="cpu")
    tp = clone_tree(tp, requires_grad=True)
    x = torch.randn(2, 16, 16, 3)
    logits, state = tconvnet.apply(tp, ts, x)
    assert not logits.requires_grad and state is ts
    a, _ = tconvnet.apply(tp, ts, x, train=True)
    b, _ = tconvnet.apply(tp, ts, x, train=True, generator=torch.Generator().manual_seed(1))
    c, _ = tconvnet.apply(tp, ts, x, train=True, generator=torch.Generator().manual_seed(1))
    assert a.requires_grad and not torch.equal(a, b) and torch.equal(b, c)
