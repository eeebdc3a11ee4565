"""Dynamic PTQ (counterpart of quantnet/quantize/dynamic.py:38-105).

Fold BN, quantize every weight to int8 (per output channel by default) and
tag every layer with a DynamicActQuant marker, so the ops quantize each
layer's input per batch. Every layer but the classifier hands its output to
the next one in `handoff` dtype (bf16 by default); the logits stay f32.
Each quantized layer keeps its GEMM kernels' frozen operands under 'gemm'
(ops/linear.py::gemm_constants).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from quantnet_torch.core.types import DynamicActQuant
from quantnet_torch.ops.linear import gemm_constants
from quantnet_torch.quantize.common import (
    first_layer_path,
    last_layer_path,
    quantize_weight,
    walk_layers,
)
from quantnet_torch.quantize.fold import fold_model


@torch.no_grad()
def quantize(
    params: dict,
    state: dict,
    *,
    per_channel: bool = True,
    skip_last_layer: bool = False,
    skip_first_layer: bool = False,
    handoff: Optional[str] = "bfloat16",
) -> Tuple[dict, dict]:
    """FP32 (params, state) -> dynamically quantized (params', {}).

    skip_first_layer / skip_last_layer keep the stem / classifier in fp32.
    The transform runs on the device the params lie on. The per-layer policy
    table and `last_layer_name` of the JAX package come with a later slice.
    """
    params, _ = fold_model(params, state)
    first, last = first_layer_path(params), last_layer_path(params)

    def q(path: str, layer: dict) -> dict:
        if (skip_last_layer and path == last) or (skip_first_layer and path == first):
            return dict(layer)
        out = dict(layer)
        out["w"] = quantize_weight(layer["w"], per_channel)
        out["aq"] = DynamicActQuant(handoff=None if path == last else handoff)
        out["gemm"] = gemm_constants(out)
        return out

    return walk_layers(params, q), {}
