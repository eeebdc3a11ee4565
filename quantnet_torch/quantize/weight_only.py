"""Weight-only quantization (counterpart of quantnet/quantize/weight_only.py:26-90).

Fold BN and quantize every weight (per output channel by default); the
activations stay fp32 and the layers carry no 'aq', so the ops multiply in
the activation dtype and apply the dequant scale after the product
(ops/linear.py, ops/conv.py). bits=4 is the sub-byte tier; with group_size,
2-D (dense) weights get group-wise scales along K.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from quantnet_torch.quantize.common import (
    last_layer_path,
    quantize_weight,
    resolve_policy,
    walk_layers,
)
from quantnet_torch.quantize.fold import fold_model


@torch.no_grad()
def quantize(
    params: dict,
    state: dict,
    *,
    per_channel: bool = True,
    skip_last_layer: bool = True,
    layer_policy: Optional[dict] = None,
    last_layer_name: Optional[str] = None,
    bits: int = 8,
    group_size: Optional[int] = None,
) -> Tuple[dict, dict]:
    """FP32 (params, state) -> weight-only-quantized (params', {}).

    The classifier stays fp32 by default (skip_last_layer). A `layer_policy`
    action 'fp32' keeps a layer in fp32; 'int8' keeps an 8-bit per-channel
    weight inside a 4-bit tier.
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    params, _ = fold_model(params, state)
    last = last_layer_name or last_layer_path(params)

    def q(path: str, layer: dict) -> dict:
        action = resolve_policy(path, "weight_only", layer_policy)
        if action == "fp32" or (skip_last_layer and path == last):
            return dict(layer)
        out = dict(layer)
        lbits = 8 if action == "int8" else bits
        out["w"] = quantize_weight(
            layer["w"], per_channel, bits=lbits, group_size=group_size if lbits == bits else None
        )
        return out

    return walk_layers(params, q), {}
