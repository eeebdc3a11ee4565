"""Quantize / dequantize primitives (counterpart of quantnet/core/quantize.py).

Numerics contract, bit for bit the JAX package's:
    q = clip(round(x / scale) + zero_point, -128, 127)    (int8)
    x' = (q - zero_point) * scale
Weights are symmetric over [-127, 127]. Rounding is half-to-even
(`torch.round`). Every scale is floored at EPS.

Quantizing divides by the scale, never multiplies by a reciprocal. PyTorch's
CUDA division turns `tensor / python_number` into a multiply by the
reciprocal, which can be an ulp off true division, so every divisor here is a
tensor (`_div`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from quantnet_torch.core.types import QTensor

INT8_MIN = -128
INT8_MAX = 127
SYM_MAX = 127.0
EPS = 1e-8


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """True (IEEE-rounded) division, also when `d` is a Python number."""
    if not isinstance(d, torch.Tensor):
        d = torch.tensor(d, dtype=x.dtype, device=x.device)
    return x / d


def _reduce_dims(ndim: int, axis: Optional[int]) -> Tuple[int, ...]:
    if axis is None:
        return tuple(range(ndim))
    axis = axis % ndim
    return tuple(i for i in range(ndim) if i != axis)


def sym_max(bits: int) -> float:
    """127 for int8, 7 for int4: -min is excluded so negation stays in range."""
    return float(2 ** (bits - 1) - 1)


def symmetric_scale(
    x: torch.Tensor, axis: Optional[int] = None, bits: int = 8
) -> torch.Tensor:
    """absmax / sym_max(bits); () per-tensor, or keepdim-shaped per-channel."""
    dims = _reduce_dims(x.ndim, axis)
    amax = torch.amax(torch.abs(x), dim=dims, keepdim=axis is not None)
    # The floor is taken in x's dtype, as the JAX package does for bf16 input.
    return _div(torch.clamp_min(amax, EPS).float(), sym_max(bits))


def quantize_symmetric(
    x: torch.Tensor, axis: Optional[int] = None, bits: int = 8
) -> QTensor:
    """Symmetric quantization (weights); per-channel along `axis` if given."""
    m = sym_max(bits)
    scale = symmetric_scale(x, axis, bits)
    q = torch.clamp(torch.round(x.float() / scale), -m, m)
    return QTensor(values=q.to(torch.int8), scale=scale, axis=axis, bits=bits)


def quantize_affine(
    x: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor
) -> torch.Tensor:
    """Quantize with given affine params -> int8."""
    q = torch.round(_div(x.float(), scale)) + zero_point
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def dynamic_quantize(
    x: torch.Tensor, axis: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch symmetric activation quantization: (int8 values, f32 scale).

    Convs take a per-tensor scale (axis=None), linears a per-row one (axis=0).
    """
    scale = symmetric_scale(x, axis)
    q = torch.clamp(torch.round(x.float() / scale), -SYM_MAX, SYM_MAX)
    return q.to(torch.int8), scale


def dequantize(
    q: torch.Tensor, scale, zero_point=None, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    v = q.to(dtype)
    if zero_point is not None:
        v = v - torch.as_tensor(zero_point, dtype=dtype, device=v.device)
    return v * torch.as_tensor(scale, dtype=dtype, device=v.device)
