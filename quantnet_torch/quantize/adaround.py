"""Learned rounding, AdaRound-style (counterpart of quantnet/quantize/adaround.py).

Nagel et al., "Up or Down? Adaptive Rounding for Post-Training
Quantization" (ICML 2020). Each quantized weight may round down or up
(floor or floor + 1 on its grid); a rectified sigmoid of a learned logit
picks between them, and a regularizer with an annealed sharpness pushes
every choice to 0 or 1. The objective is layer-local: each layer's
soft-rounded output against its own fp32 output, on its captured fp32
input (fake-quantized through the layer's frozen ActQuant for the tiers
that quantize activations, so the objective isolates the rounding error the
deployed graph sees).

All layers optimize jointly: one autograd graph over a dict of
rounding-logit tensors, the sum of the per-layer normalized reconstruction
losses plus the regularizer, and one `torch.optim.Adam` step (optax's adam
defaults). The fp32 lanes run through the port's f32 conv2d / linear (cuDNN
and cuBLAS with TF32 off on the card). The refined tree keeps its scales,
zero points and group layout; only the int payload changes, by at most 1
LSB, and the static trees' `wsum` and GEMM constants are made again. The soft
loss starts near 0 (the soft weights start at the fp32 ones) and grows as
the regularizer pins them; `reconstruction_loss` holds the hard rounding
against nearest rounding's on the same objective.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from quantnet_torch.core.quantize import sym_max
from quantnet_torch.core.types import QTensor
from quantnet_torch.quantize.bias_correct import (
    apply_spec,
    capture_specs,
    deployed_input,
    first_batches,
    with_layer,
)
from quantnet_torch.quantize.common import walk_layers, weight_colsum
from quantnet_torch.quantize.fold import fold_model

# Rectified-sigmoid stretch (Nagel et al. 2020, eq. 23).
GAMMA, ZETA = -0.1, 1.1
_EPS = 1e-4


def _rect_sigmoid(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(v) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def _rect_sigmoid_inv(h: torch.Tensor) -> torch.Tensor:
    h = torch.clamp(h, _EPS, 1.0 - _EPS)
    p = (h - GAMMA) / (ZETA - GAMMA)
    return torch.log(p) - torch.log1p(-p)


def _scale_full(qt: QTensor) -> torch.Tensor:
    """The dequant scale broadcast to the payload's shape (per tensor, per
    channel or per group)."""
    shape = qt.values.shape
    if qt.group_size is not None:
        g = qt.group_size
        return qt.scale.expand(shape[0] // g, g, *shape[1:]).reshape(shape)
    return qt.scale.expand(shape)


def _refinable_paths(qparams: dict) -> list:
    paths = []

    def visit(path, layer):
        if isinstance(layer.get("w"), QTensor):
            paths.append(path)
        return layer

    walk_layers(qparams, visit)
    return sorted(paths)


def _layers(tree: dict, paths) -> dict:
    out = {}

    def grab(path, layer):
        if path in paths:
            out[path] = layer
        return layer

    walk_layers(tree, grab)
    return out


@torch.no_grad()
def _captured(apply_fn, fparams, fstate, qls, fp_layers, paths, batches, max_examples):
    """(specs, [(inputs, fp32 outputs) per batch]): each layer's input in
    the deployed domain and its fp32 output, from one fp32 forward a batch."""
    xs_in = first_batches(batches, max_examples, "refine")
    specs = capture_specs(apply_fn, fparams, fstate, xs_in[0])
    missing = [p for p in paths if p not in specs]
    if missing:
        raise ValueError(f"model did not record op specs for {missing}; layer-local refinement "
                         "needs the '__specs__' capture side channel")
    acts = []
    for x in xs_in:
        cap: dict = {}
        apply_fn(fparams, fstate, x, capture=cap)
        xs = {p: deployed_input(cap[p], qls[p].get("aq")) for p in paths}
        acts.append((xs, {p: apply_spec(specs[p], fp_layers[p], xs[p]) for p in paths}))
    return specs, acts


def _recon(spec, layer, w, x, y):
    """One layer's normalized reconstruction error with weight `w`."""
    pred = apply_spec(spec, dict(layer, w=w), x)
    return torch.mean(torch.square(pred - y)) / (torch.mean(torch.square(y)) + 1e-8)


@torch.no_grad()
def reconstruction_loss(qparams: dict, params: dict, state: dict, apply_fn, batches: Iterable, *,
                        max_examples: int = 512) -> float:
    """refine's reconstruction objective with the tree's hard weights (its
    int payloads dequantized): the sum over its quantized layers, averaged
    over the calibration batches refine would take. Nearest rounding's tree
    and a refined one compare on it."""
    fparams, fstate = fold_model(params, state)
    paths = tuple(_refinable_paths(qparams))
    qls, fp_layers = _layers(qparams, paths), _layers(fparams, paths)
    specs, acts = _captured(apply_fn, fparams, fstate, qls, fp_layers, paths, batches, max_examples)
    total = sum(float(_recon(specs[p], fp_layers[p], qls[p]["w"].dequantize(), xs[p], ys[p]))
                for xs, ys in acts for p in paths)
    return total / len(acts)


@torch.no_grad()
def _init_rounding(qparams: dict, fparams: dict, paths) -> Tuple[dict, dict]:
    """Per path: the floor of the fp32 weight on the quantization grid, and
    the initial rounding logits (the rectified sigmoid's inverse of the
    fraction, so the soft weight starts at the fp32 one)."""
    qls, fls = _layers(qparams, paths), _layers(fparams, paths)
    floors, logits = {}, {}
    for p in paths:
        grid = fls[p]["w"].float() / _scale_full(qls[p]["w"])
        floors[p] = torch.floor(grid)
        logits[p] = _rect_sigmoid_inv(grid - floors[p])
    return floors, logits


def refine(
    qparams: dict,
    qstate: dict,
    params: dict,
    state: dict,
    apply_fn,
    batches: Iterable,
    *,
    steps: int = 400,
    lr: float = 1e-2,
    reg_lambda: float = 0.01,
    beta_range: Tuple[float, float] = (20.0, 2.0),
    layer_filter: Optional[Tuple[str, ...]] = None,
    max_examples: int = 512,
) -> Tuple[dict, dict]:
    """Refine a quantized tree's weight rounding on calibration data.

    qparams / qstate: any tree whose quantized layers hold QTensor weights
    (weight-only, static, W4A8; int8 or 4-bit; per tensor, per channel or
    grouped). params / state: the fp32 tree it came from (BN folded here
    again so the paths line up). Each refined layer's input and fp32 output
    on the first batches, up to `max_examples` images, are captured once and
    stay on the device (about twice the layers' summed activations per
    image). layer_filter: refine only these paths.

    Returns the tree with only the int payloads moved (by at most 1) and
    `wsum` / GEMM constants made again."""
    fparams, fstate = fold_model(params, state)
    paths = tuple(p for p in _refinable_paths(qparams) if layer_filter is None or p in layer_filter)
    if not paths:
        return qparams, qstate
    floors, logits = _init_rounding(qparams, fparams, paths)
    qls, fp_layers = _layers(qparams, paths), _layers(fparams, paths)
    scales = {p: _scale_full(qls[p]["w"]) for p in paths}
    maxes = {p: sym_max(qls[p]["w"].bits) for p in paths}

    specs, acts = _captured(apply_fn, fparams, fstate, qls, fp_layers, paths, batches, max_examples)
    leaves = [logits[p].requires_grad_() for p in paths]
    opt = torch.optim.Adam(leaves, lr=lr)
    b0, b1 = beta_range
    for i in range(steps):
        # The regularizer's sharpness anneals geometrically from b0 to b1:
        # soft choices early, pinned to 0 / 1 late. Computed in Python,
        # applied in f32.
        beta = torch.tensor(b0 * (b1 / b0) ** (i / max(steps - 1, 1)), dtype=torch.float32,
                            device=floors[paths[0]].device)
        xs, ys = acts[i % len(acts)]
        recon = reg = 0.0
        for p in paths:
            h = _rect_sigmoid(logits[p])
            w = torch.clamp(floors[p] + h, -maxes[p], maxes[p]) * scales[p]
            # Each layer's error is normalized by its output's power, so
            # wide or deep layers do not drown the rest of the sum.
            recon = recon + _recon(specs[p], fp_layers[p], w, xs[p], ys[p])
            reg = reg + torch.mean(1.0 - torch.abs(2.0 * h - 1.0) ** beta)
        opt.zero_grad(set_to_none=True)
        (recon + reg_lambda * reg).backward()
        opt.step()
    return _bake(qparams, qstate, floors, logits, paths)


@torch.no_grad()
def _bake(qparams, qstate, floors, logits, paths):
    def bake(path, layer):
        if path not in paths:
            return layer
        qt = layer["w"]
        m = sym_max(qt.bits)
        # An exact 0.5 bakes up (>=), where nearest rounding goes to even:
        # the two differ only on grid midpoints.
        hard = (_rect_sigmoid(logits[path]) >= 0.5).float()
        values = torch.clamp(floors[path] + hard, -m, m).to(torch.int8)
        qw = QTensor(values=values, scale=qt.scale, zero_point=qt.zero_point, axis=qt.axis,
                     bits=qt.bits, group_size=qt.group_size)
        leaves = {"w": qw}
        if "wsum" in layer:
            leaves["wsum"] = weight_colsum(qw)
        return with_layer(layer, **leaves)

    return walk_layers(qparams, bake), qstate
