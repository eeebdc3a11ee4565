"""Shared helpers of the quantization transforms (counterpart of
quantnet/quantize/common.py:18-113, 154-205): layer walking, weight
quantization, weight column sums, the s4 runtime payload, first / last
layer resolution and the per-layer policy lookup.

A "layer" is any dict in the params tree holding key 'w'; layers are
addressed by path ('conv1', 'layer3/2/conv2').
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import torch

from quantnet_torch.core.quantize import quantize_symmetric, quantize_symmetric_grouped
from quantnet_torch.core.types import QTensor


def is_layer(node) -> bool:
    return isinstance(node, dict) and "w" in node


def walk_layers(params: dict, fn: Callable[[str, dict], dict], prefix: str = "") -> dict:
    """Rebuild the params tree, applying fn(path, layer_dict) to every layer."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if is_layer(v):
            out[k] = fn(path, v)
        elif isinstance(v, dict):
            out[k] = walk_layers(v, fn, path)
        else:
            out[k] = v
    return out


def layer_paths(params: dict, prefix: str = "") -> list:
    paths = []
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if is_layer(v):
            paths.append(path)
        elif isinstance(v, dict):
            paths.extend(layer_paths(v, path))
    return paths


def quantize_weight(
    w: torch.Tensor, per_channel: bool, bits: int = 8, group_size: Optional[int] = None
) -> QTensor:
    """Symmetric weight quantization; channel axis = last (HWIO / KN).

    group_size gives a 2-D (K, N) weight group-wise scales along K, where
    group_size divides K and per_channel is asked for; a conv kernel (4-D)
    or a K it does not divide falls back to per channel, as in
    quantnet/quantize/common.py:47-68.

    The JAX package quantizes weights inside its jitted transforms, where
    XLA takes `amax / 127` as a multiply by the f32 reciprocal; the port's
    quantizers do the same, so both bake the same bits.
    """
    if per_channel and group_size is not None and w.ndim == 2 and w.shape[0] % group_size == 0:
        return quantize_symmetric_grouped(w, group_size, bits=bits)
    axis = (w.ndim - 1) if per_channel else None
    return quantize_symmetric(w, axis=axis, bits=bits)


def weight_colsum(qw: QTensor) -> torch.Tensor:
    """int32[O]: the per-output-channel sum of the int8 weight, the static
    path's zero-point correction (x - zp) @ w = x @ w - zp * colsum(w).
    int32[G, O] for a grouped weight, one colsum per group of rows: its
    scale varies along K, so the correction stays per group (W4A8)."""
    v = qw.values.to(torch.int32)
    if qw.group_size is not None:
        g = qw.group_size
        return v.reshape(v.shape[0] // g, g, *v.shape[1:]).sum(dim=1, dtype=torch.int32)
    return v.sum(dim=tuple(range(v.ndim - 1)), dtype=torch.int32)


def s4_runtime_tree(params: dict) -> dict:
    """Deployment-time transform (quantnet/quantize/common.py:90-113): every
    4-bit weight's payload nibble-packed (QTensor.packed), so it occupies 4
    bits in device memory; 8-bit (and int4-guarded) layers are untouched.
    The layers' GEMM constants are made again from the packed weight: K1
    reads the packed operand itself (its packed-B mode), so no int8-wide
    copy of a 4-bit weight stays on the device. The weight-only ops and K4
    widen the payload transiently, in torch ops, where XLA converts the int4
    payload in its graph. Forwards are bit-identical to the int8-wide
    tree's. Applied after load or quantize; artifacts stay in their disk
    format.

    The JAX package's `s4_io_supported` probe asks whether a TPU stack can
    pass int4 arrays into jit; a uint8 tensor has no such limit, so the port
    needs no probe."""
    from quantnet_torch.ops.linear import gemm_constants, needs_gemm_constants

    def q(path: str, layer: dict) -> dict:
        w = layer.get("w")
        if not (isinstance(w, QTensor) and w.bits == 4 and not w.is_packed):
            return layer
        out = dict(layer)
        out["w"] = w.packed()
        if needs_gemm_constants(out):
            out["gemm"] = gemm_constants(out)
        return out

    return walk_layers(params, q)


# Model-order anchors of the package's naming: stems first, classifier heads
# last, body stages between them in natural-numeric order (block2 < block10).
# Dict order is not used: a tree rebuilt in another order (the JAX package's
# jit sorts dict keys) would otherwise pick the wrong first / last layer.
_ORDER_GROUPS = {"conv_stem": 0, "conv_head": 3}


def _model_order_key(path: str):
    parts = path.split("/")
    top = parts[0]
    if top in _ORDER_GROUPS:
        group = _ORDER_GROUPS[top]
    elif top.startswith("fc"):
        group = 4
    elif top.startswith("conv"):
        group = 1
    else:
        group = 2
    nat = tuple(
        tuple(int(t) if t.isdigit() else t for t in re.split(r"(\d+)", p))
        for p in parts
    )
    return (group,) + nat


def last_layer_path(params: dict) -> Optional[str]:
    """Path of the classifier layer ('fc2' for SimpleConvNet)."""
    paths = layer_paths(params)
    return max(paths, key=_model_order_key) if paths else None


def first_layer_path(params: dict) -> Optional[str]:
    """Path of the stem layer ('conv1' for SimpleConvNet)."""
    paths = layer_paths(params)
    return min(paths, key=_model_order_key) if paths else None


def resolve_policy(path: str, default: str, policy: Optional[Dict[str, str]]) -> str:
    """Most-specific match: the exact path, then the leaf name, else default."""
    if not policy:
        return default
    if path in policy:
        return policy[path]
    return policy.get(path.rsplit("/", 1)[-1], default)
