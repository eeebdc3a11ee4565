"""Empirical bias correction (counterpart of quantnet/quantize/bias_correct.py).

Nagel et al. 2019, section 4.2. Weight quantization is not zero-mean per
output channel: rounding and clipping shift each channel's expected
response. The shift is measured on calibration data and taken out of the
layer's bias:

    e_c = mean over batch and space of (q_layer(x) - fp32_layer(x))_c
    b'  = b - e

before the activation, where x is the layer's input in the deployed domain:
its fp32 input fake-quantized through the layer's frozen ActQuant, where it
has one. One fp32 capture pass per batch gives every layer's input; each
layer is then replayed from its op spec (the models' `__specs__` capture)
through the port's ops, which on the card run the int8 kernels for a static
layer. Only the 'b' leaves change (and the GEMM constants made from them).
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch

from quantnet_torch.core.quantize import dequantize, quantize_affine
from quantnet_torch.core.types import ActQuant, QTensor
from quantnet_torch.ops.conv import conv2d
from quantnet_torch.ops.linear import gemm_constants, linear, needs_gemm_constants
from quantnet_torch.quantize.common import walk_layers
from quantnet_torch.quantize.fold import fold_model


def apply_spec(spec: tuple, layer: dict, x: torch.Tensor, *, activation: bool = True) -> torch.Tensor:
    """Replay one layer's op outside the model from its captured spec
    (kind, stride, padding, activation); `activation=False` leaves the
    activation out. A "dwconv" takes its groups from x's channels."""
    kind, stride, padding, act = spec
    act = act if activation else None
    if kind == "conv":
        return conv2d(layer, x, stride=stride, padding=padding, activation=act)
    if kind == "dwconv":
        return conv2d(layer, x, stride=stride, padding=padding, activation=act, groups=x.shape[-1])
    return linear(layer, x, activation=act)


def capture_specs(apply_fn, params: dict, state: dict, x: torch.Tensor) -> dict:
    """{path: spec} of every BN-folded layer, from one forward with the
    `__specs__` side channel seeded (the JAX package traces it with
    jax.eval_shape)."""
    cap = {"__specs__": {}}
    with torch.no_grad():
        apply_fn(params, state, x, capture=cap)
    return cap["__specs__"]


def first_batches(batches: Iterable, max_examples: int, caller: str) -> list:
    """The calibration images, batch by batch, up to the first batch that
    reaches `max_examples` (a batch is an image tensor or a tuple whose
    first item is one)."""
    xs, total = [], 0
    for batch in batches:
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        xs.append(x)
        total += x.shape[0]
        if total >= max_examples:
            break
    if not xs:
        raise ValueError(f"{caller}() needs at least one calibration batch")
    return xs


def deployed_input(x: torch.Tensor, aq) -> torch.Tensor:
    """A layer's fp32 input as the deployed graph sees it: fake-quantized
    through a frozen ActQuant, else as it is."""
    if not isinstance(aq, ActQuant):
        return x
    return dequantize(quantize_affine(x, aq.scale, aq.zero_point), aq.scale, aq.zero_point)


def _without_bias(layer: dict) -> dict:
    out = {k: v for k, v in layer.items() if k not in ("b", "gemm")}
    if needs_gemm_constants(out):
        out["gemm"] = gemm_constants(out)
    return out


def with_layer(layer: dict, **leaves) -> dict:
    """The layer with some leaves replaced, its GEMM constants made again
    from them where it keeps any."""
    out = dict(layer, **leaves)
    if "gemm" in out:
        out["gemm"] = gemm_constants(out)
    return out


@torch.no_grad()
def bias_correct(
    qparams: dict,
    qstate: dict,
    params: dict,
    state: dict,
    apply_fn,
    batches: Iterable,
    *,
    max_examples: int = 512,
) -> Tuple[dict, dict]:
    """A quantized (qparams, qstate) -> the same tree with corrected biases.

    params / state: the fp32 tree the quantized one came from (BN folded
    here again, as adaround.refine does). batches: calibration batches, up
    to `max_examples` images. Layers without a QTensor weight or a bias pass
    through unchanged."""
    fparams, fstate = fold_model(params, state)
    q_layers, fp_layers = {}, {}

    def grab_q(path, layer):
        if isinstance(layer.get("w"), QTensor) and layer.get("b") is not None:
            q_layers[path] = layer
        return layer

    walk_layers(qparams, grab_q)
    if not q_layers:
        return qparams, qstate
    paths = tuple(sorted(q_layers))

    def grab_fp(path, layer):
        if path in q_layers:
            fp_layers[path] = layer
        return layer

    walk_layers(fparams, grab_fp)
    xs = first_batches(batches, max_examples, "bias_correct")
    specs = capture_specs(apply_fn, fparams, fstate, xs[0])
    missing = [p for p in paths if p not in specs]
    if missing:
        raise ValueError(f"model did not record op specs for {missing}; bias correction needs "
                         "the '__specs__' capture side channel")
    # The bias cancels in the difference, so both lanes run without it.
    q_nob = {p: _without_bias(q_layers[p]) for p in paths}
    f_nob = {p: _without_bias(fp_layers[p]) for p in paths}

    sums, counts = {p: 0.0 for p in paths}, {p: 0 for p in paths}
    for x in xs:
        cap: dict = {}
        apply_fn(fparams, fstate, x, capture=cap)
        for p in paths:
            xi = deployed_input(cap[p], q_layers[p].get("aq"))
            err = (apply_spec(specs[p], q_nob[p], xi, activation=False)
                   - apply_spec(specs[p], f_nob[p], xi, activation=False))
            sums[p] = sums[p] + torch.sum(err, dim=tuple(range(err.ndim - 1)))
            counts[p] += err.numel() // err.shape[-1]

    def correct(path, layer):
        if path not in q_layers:
            return layer
        # The mean divides by the count as an f32 tensor: a CUDA division
        # by a Python number multiplies by its reciprocal.
        n = torch.tensor(float(counts[path]), device=sums[path].device)
        return with_layer(layer, b=layer["b"] - sums[path] / n)

    return walk_layers(qparams, correct), qstate
