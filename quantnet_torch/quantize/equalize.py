"""Cross-layer equalization (counterpart of quantnet/quantize/equalize.py).

Nagel et al., "Data-Free Quantization Through Weight Equalization and Bias
Correction" (ICCV 2019). ReLU is positively homogeneous, so for two
connected layers y = W2 relu(W1 x + b1) + b2 a per-channel rescale S of
layer 1's output is absorbed by layer 2: W1' = S W1, b1' = S b1,
W2' = W2 S^-1. The scale s_c = sqrt(r1_c r2_c) / r1_c (r: a channel's
weight absmax) brings both layers' ranges to sqrt(r1_c r2_c), which is what
per-tensor weight quantization needs.

A pure transform on tensors, after the BN fold. The pairs follow the
model's structure (`detect_pairs`): the convnet's whole chain (conv6 -> fc1
across the NHWC flatten), ResNet's intra-block pairs (residual joins are
never crossed), MobileNetV2's stem -> block0/dw, expand -> dw and dw ->
project. ReLU6 is homogeneous only below its clip, so on MobileNetV2 the
transform preserves the function only where no pre-activation reaches 6.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from quantnet_torch.quantize.fold import fold_model

_EPS = 1e-9

# (first layer, second layer, kind): how the second layer's weight indexes
# the first's output channels. "conv": HWIO input axis 2; "dw_in": a
# depthwise (kh, kw, 1, C) kernel, channel c into channel c; "fc": (C, out)
# rows; "fc_flat": (H*W*C, out) rows with C fastest (the NHWC flatten).
PairSpec = Tuple[str, str, str]


def _get(tree: dict, path: str) -> dict:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def detect_pairs(params: dict) -> Tuple[PairSpec, ...]:
    """The equalizable pairs of a convnet, ResNet or MobileNetV2 tree
    (quantnet/quantize/equalize.py:63-122)."""
    pairs: List[PairSpec] = []
    if "conv_stem" in params:
        names = sorted((k for k in params if k.startswith("block")), key=lambda k: int(k[5:]))
        if names:
            pairs.append(("conv_stem", f"{names[0]}/dw", "dw_in"))
        for name in names:
            if "expand" in params[name]:
                pairs.append((f"{name}/expand", f"{name}/dw", "dw_in"))
            pairs.append((f"{name}/dw", f"{name}/project", "conv"))
        return tuple(pairs)
    if "conv1" in params and "fc1" in params and "layer1" not in params:
        convs = []
        while f"conv{len(convs) + 1}" in params:
            convs.append(f"conv{len(convs) + 1}")
        pairs.extend((a, b, "conv") for a, b in zip(convs, convs[1:]))
        if convs:
            pairs.append((convs[-1], "fc1", "fc_flat"))
        if "fc2" in params:
            pairs.append(("fc1", "fc2", "fc"))
        return tuple(pairs)
    for si in range(1, 5):
        stage = params.get(f"layer{si}")
        if not isinstance(stage, dict):
            continue
        for bi in sorted(stage, key=int):
            block, t = stage[bi], f"layer{si}/{bi}"
            if "conv2" in block:
                pairs.append((f"{t}/conv1", f"{t}/conv2", "conv"))
            if "conv3" in block:
                pairs.append((f"{t}/conv2", f"{t}/conv3", "conv"))
    return tuple(pairs)


def _ranges(w1: torch.Tensor, w2: torch.Tensor, kind: str):
    """(r1, r2, shape2): the absmax of layer 1's output channels and of
    layer 2's matching input axis, and the shape that divides w2 (None for
    fc_flat, which divides a 3-D view)."""
    c = w1.shape[-1]
    r1 = torch.amax(torch.abs(w1.reshape(-1, c)), dim=0)
    if kind == "conv":
        return r1, torch.amax(torch.abs(w2), dim=(0, 1, 3)), (1, 1, c, 1)
    if kind == "dw_in":
        return r1, torch.amax(torch.abs(w2), dim=(0, 1, 2)), (1, 1, 1, c)
    if kind == "fc":
        return r1, torch.amax(torch.abs(w2), dim=1), (c, 1)
    if kind == "fc_flat":
        return r1, torch.amax(torch.abs(w2.reshape(-1, c, w2.shape[-1])), dim=(0, 2)), None
    raise ValueError(f"unknown pair kind {kind!r}")


def _set(tree: dict, path: str, layer: dict) -> dict:
    keys = path.split("/")
    out = dict(tree)
    node = out
    for k in keys[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    node[keys[-1]] = layer
    return out


@torch.no_grad()
def _equalize(params: dict, pairs: Tuple[PairSpec, ...], iterations: int) -> dict:
    """The pair sweeps, in the JAX package's order and f32 rounding. Its
    transform runs under jit, where XLA rewrites (A / B) / C as A / (B * C):
    a weight divided twice in a row (the second layer of a pair in both
    sweeps, and no pair scaling it between) is divided once by the product,
    and so it is here (`divided`: path -> (weight before the divisions, their
    product))."""
    divided = {}
    for _ in range(iterations):
        for p1, p2, kind in pairs:
            l1, l2 = dict(_get(params, p1)), dict(_get(params, p2))
            w1, w2 = l1["w"], l2["w"]
            r1, r2, shape2 = _ranges(w1, w2, kind)
            # A dead channel (either range about 0) keeps s = 1. The square
            # root is taken in f64 and rounded once to f32, the correctly
            # rounded f32 root XLA computes: PyTorch's vectorized f32 sqrt
            # on the CPU can be an ulp off.
            root = torch.sqrt((r1 * r2).double()).float()
            s = torch.where((r1 > _EPS) & (r2 > _EPS), root / (r1 + _EPS), torch.ones_like(r1))
            l1["w"] = w1 * s
            divided.pop(p1, None)
            if l1.get("b") is not None:
                l1["b"] = l1["b"] * s
            base, d = divided.get(p2, (w2, None))
            d = s if d is None else d * s
            divided[p2] = (base, d)
            if kind == "fc_flat":
                c = w1.shape[-1]
                l2["w"] = (base.reshape(-1, c, w2.shape[-1]) / d[None, :, None]).reshape(w2.shape)
            else:
                l2["w"] = base / d.reshape(shape2)
            params = _set(_set(params, p1, l1), p2, l2)
    return params


def cross_layer_equalize(
    params: dict,
    state: dict,
    *,
    pairs: Optional[Tuple[PairSpec, ...]] = None,
    iterations: int = 2,
) -> Tuple[dict, dict]:
    """fp32 (params, state) -> equalized, BN-folded (params', state'), before
    any quantize transform. `iterations` sweeps the pair chain so scales
    travel along longer chains; `pairs` defaults to detect_pairs."""
    params, state = fold_model(params, state)
    pairs = detect_pairs(params) if pairs is None else tuple(pairs)
    if not pairs:
        return params, state
    return _equalize(params, pairs, iterations), state
