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
    skip_last_layer: bool = False,
    skip_first_layer: bool = False,
    layer_policy: Optional[dict] = None,
    last_layer_name: Optional[str] = None,
    handoff: Optional[str] = "bfloat16",
) -> Tuple[dict, dict]:
    """FP32 (params, state) -> dynamically quantized (params', {}).

    skip_first_layer / skip_last_layer keep the stem / classifier in fp32.
    An explicit `layer_policy` entry (exact path or leaf name) wins over the
    skip flags; 'fp32' keeps a layer in fp32. `last_layer_name` names the
    classifier (found from the tree's layer names otherwise), whose logits
    stay f32. The transform runs on the device the params lie on.
    """
    params, _ = fold_model(params, state)
    last = last_layer_name or last_layer_path(params)
    first = first_layer_path(params)

    def q(path: str, layer: dict) -> dict:
        action = resolve_policy(path, "dynamic", layer_policy)
        explicit = bool(layer_policy) and (
            path in layer_policy or path.rsplit("/", 1)[-1] in layer_policy
        )
        skipped = (skip_last_layer and path == last) or (skip_first_layer and path == first)
        if action == "fp32" or (not explicit and skipped):
            return dict(layer)
        out = dict(layer)
        out["w"] = quantize_weight(layer["w"], per_channel)
        out["aq"] = DynamicActQuant(handoff=None if path == last else handoff)
        out["gemm"] = gemm_constants(out)
        return out

    return walk_layers(params, q), {}
