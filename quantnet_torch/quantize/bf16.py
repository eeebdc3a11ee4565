"""bf16 inference (counterpart of quantnet/quantize/bf16.py): fold BN, then
cast every f32 tensor of the tree to bfloat16. The ops then multiply bf16
operands with f32 accumulation and an f32 result (ops/linear.py, ops/conv.py).
"""
from __future__ import annotations

from typing import Tuple

import torch

from quantnet_torch.quantize.fold import fold_model


def _cast(node):
    if isinstance(node, dict):
        return {k: _cast(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor) and node.dtype == torch.float32:
        return node.to(torch.bfloat16)
    return node


@torch.no_grad()
def quantize(params: dict, state: dict) -> Tuple[dict, dict]:
    """FP32 (params, state) -> BN-folded bf16 (params', {})."""
    params, _ = fold_model(params, state)
    return _cast(params), {}
