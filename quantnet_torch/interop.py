"""Carry the JAX package's parameter trees over into the port.

The trees arrive as numpy: `jax.tree.map(np.asarray, tree)` keeps the JAX
package's own leaf objects (its QTensor, with numpy `values` / `scale`, its
ActQuant with numpy `scale` / `zero_point`, its DynamicActQuant and QAT
FakeQuant markers) and turns every array into numpy (a static layer's
'wsum' among them). This module reads those objects by their attributes and
imports nothing of the JAX package. Layouts are the same on both sides (HWIO / (K, N) weights), so no
array is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from quantnet_torch.core.config import resolve_device
from quantnet_torch.core.types import ActQuant, DynamicActQuant, FakeQuant, QTensor
from quantnet_torch.ops.linear import with_gemm_constants


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own: widen, then narrow
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(node, device):
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if hasattr(node, "weight_bits") and hasattr(node, "act_quant"):  # a QAT FakeQuant marker
        return FakeQuant(node.scale, node.zero_point, node.per_channel, node.weight_bits,
                         node.weight_group_size, node.act_quant)
    if hasattr(node, "values") and hasattr(node, "scale"):  # a QTensor
        zp = getattr(node, "zero_point", None)
        return QTensor(
            values=_tensor(node.values, device),
            scale=_tensor(node.scale, device),
            zero_point=None if zp is None else _tensor(zp, device),
            axis=node.axis,
            bits=node.bits,
            group_size=getattr(node, "group_size", None),
        )
    if hasattr(node, "scale") and hasattr(node, "zero_point"):  # an ActQuant ('aq', 'oq')
        return ActQuant(scale=_tensor(node.scale, device), zero_point=_tensor(node.zero_point, device))
    if hasattr(node, "handoff"):  # a DynamicActQuant marker
        return DynamicActQuant(handoff=node.handoff)
    if isinstance(node, (np.ndarray, np.generic)):
        return _tensor(node, device)
    raise TypeError(f"cannot carry over a {type(node).__name__} leaf")


def from_jax_params(params_np: dict, state_np: dict, *, device="cuda"):
    """fp32 (params, state) of the JAX package, as numpy -> the port's."""
    device = resolve_device(device)
    return with_gemm_constants(_convert(params_np, device)), _convert(state_np, device)


def from_jax_qparams(qparams_np: dict, *, device="cuda") -> dict:
    """A quantized params tree of the JAX package, as numpy -> the port's."""
    # The kernels' operands are made once here.
    return with_gemm_constants(_convert(qparams_np, resolve_device(device)))
