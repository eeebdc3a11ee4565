"""BatchNorm folding (counterpart of quantnet/quantize/fold.py:20-60).

Every layer dict carrying a 'bn' sub-dict gets the BN affine folded into its
weights and bias and loses the 'bn' entry; the model's apply then skips BN.
"""
from __future__ import annotations

from typing import Tuple

from quantnet_torch.ops.layers import fold_batchnorm_into_conv
from quantnet_torch.quantize.common import walk_layers


def can_fold(layer: dict) -> bool:
    return "bn" in layer


def _lookup_state(state: dict, path: str):
    node = state
    for part in path.split("/"):
        node = node[part]
    return node


def fold_model(params: dict, state: dict) -> Tuple[dict, dict]:
    """Fold all BN layers into their conv / dense. Returns (params', {}).
    Idempotent: layers without 'bn' pass through."""

    def fold_one(path: str, layer: dict) -> dict:
        if not can_fold(layer):
            return dict(layer)
        w, b = fold_batchnorm_into_conv(
            layer["w"], layer.get("b"), layer["bn"], _lookup_state(state, path)
        )
        out = {k: v for k, v in layer.items() if k != "bn"}
        out["w"], out["b"] = w, b
        return out

    return walk_layers(params, fold_one), {}
