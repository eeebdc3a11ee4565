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

The exceptions copy the JAX package's jitted forward and transforms. Every
real JAX path runs under jit (the bench, the evaluator, serving, the weight
bakes, calibration's extraction), and there XLA rewrites a division by a
compile-time constant into a multiply by the constant's f32 reciprocal:
`amax / 127` in `symmetric_scale` (the runtime activation scale of
`dynamic_quantize` and the weight bakes, quantnet/quantize/dynamic.py:31-69,
static.py:255-304) and `/ 255` in `affine_qparams` (static.py:100). The port
always computes those as `* f32(1 / c)`, so its activation scales and baked
trees hold the same bits as the jitted JAX package's (eager JAX divides, and
differs from both in about 5% of per-row scales).

QAT's straight-through fake quantizers (`fake_quant_act_ste`,
`fake_quant_weight_ste`) compute the JAX package's floats, and `clip` gives
jnp.clip's gradient, which is 0.5, not 1, on the clip's ends.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _f32_reciprocal(c: float) -> float:
    """f32(1 / c), as a Python float (exactly that f32 value)."""
    return (torch.tensor(1.0, dtype=torch.float32) / torch.tensor(c, dtype=torch.float32)).item()


def _mul_reciprocal(x: torch.Tensor, c: float) -> torch.Tensor:
    """x * f32(1 / c): x / c as XLA computes it under jit. The reciprocal goes
    in as a Python number, which an f32 product takes as that f32 value, so
    no call copies a constant to the card."""
    return x * _f32_reciprocal(c)


def _reduce_dims(ndim: int, axis: Optional[int]) -> Tuple[int, ...]:
    if axis is None:
        return tuple(range(ndim))
    axis = axis % ndim
    return tuple(i for i in range(ndim) if i != axis)


def sym_max(bits: int) -> float:
    """127 for int8, 7 for int4: -min is excluded so negation stays in range."""
    return float(2 ** (bits - 1) - 1)


def symmetric_scale(x: torch.Tensor, axis: Optional[int] = None, bits: int = 8,
                    reduce_max: Optional[Callable] = None) -> torch.Tensor:
    """absmax * f32(1 / sym_max(bits)), as XLA computes absmax / sym_max under
    jit; () per-tensor, or keepdim-shaped per-channel. `reduce_max` takes
    the absmax over the other shards of a reduction that the model axis
    splits (parallel/tensor.py, an all-reduce max, exact)."""
    dims = _reduce_dims(x.ndim, axis)
    amax = torch.amax(torch.abs(x), dim=dims, keepdim=axis is not None)
    if reduce_max is not None:
        amax = reduce_max(amax)
    # The floor is taken in x's dtype, as the JAX package does for bf16 input.
    amax = torch.clamp_min(amax, EPS).float()
    return _mul_reciprocal(amax, sym_max(bits))


def quantize_symmetric(x: torch.Tensor, axis: Optional[int] = None, bits: int = 8,
                       reduce_max: Optional[Callable] = None) -> QTensor:
    """Symmetric quantization (weights); per-channel along `axis` if given;
    the absmax through `reduce_max` where given (symmetric_scale)."""
    m = sym_max(bits)
    scale = symmetric_scale(x, axis, bits, reduce_max)
    q = torch.clamp(torch.round(x.float() / scale), -m, m)
    return QTensor(values=q.to(torch.int8), scale=scale, axis=axis, bits=bits)


def quantize_symmetric_grouped(w: torch.Tensor, group_size: int, bits: int = 4) -> QTensor:
    """Group-wise symmetric weight quantization along the reduction axis 0
    (quantnet/core/quantize.py:74-100): the (K, ...) weight splits into
    K // group_size row groups, each with its own absmax scale, shaped
    (K // g, 1, ...). group_size must divide K."""
    k = w.shape[0]
    if k % group_size:
        raise ValueError(f"group_size {group_size} must divide K={k}")
    m = sym_max(bits)
    g = w.float().reshape(k // group_size, group_size, *w.shape[1:])
    amax = torch.amax(torch.abs(g), dim=1, keepdim=True)
    scale = _mul_reciprocal(torch.clamp_min(amax, EPS), m)
    q = torch.clamp(torch.round(g / scale), -m, m).reshape(w.shape)
    return QTensor(values=q.to(torch.int8), scale=scale, bits=bits, group_size=group_size)


def affine_qparams(xmin: torch.Tensor, xmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric (f32 scale, int32 zero_point) covering [min(xmin, 0),
    max(xmax, 0)]: the range is widened to hold 0 exactly, so padding with
    the zero point is exact (quantnet/core/quantize.py:102-116). The span is
    multiplied by f32(1 / 255), as XLA computes it under calibration's jit."""
    xmin = torch.clamp_max(xmin.float(), 0.0)
    xmax = torch.clamp_min(xmax.float(), 0.0)
    scale = torch.clamp_min(_mul_reciprocal(xmax - xmin, float(INT8_MAX - INT8_MIN)), EPS)
    zero_point = torch.clamp(torch.round(INT8_MIN - xmin / scale), INT8_MIN, INT8_MAX)
    return scale, zero_point.to(torch.int32)


def quantize_affine(
    x: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor
) -> torch.Tensor:
    """Quantize with given affine params -> int8."""
    q = torch.round(_div(x.float(), scale)) + zero_point
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def dynamic_quantize(
    x: torch.Tensor, axis: Optional[int] = None, reduce_max: Optional[Callable] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch symmetric activation quantization: (int8 values, f32 scale).

    Convs take a per-tensor scale (axis=None), linears a per-row one (axis=0).
    The scale is the jitted JAX forward's (`symmetric_scale`), its absmax
    through `reduce_max` on a row shard of the model axis.
    """
    scale = symmetric_scale(x, axis, reduce_max=reduce_max)
    q = torch.clamp(torch.round(x.float() / scale), -SYM_MAX, SYM_MAX)
    return q.to(torch.int8), scale


def dequantize(
    q: torch.Tensor, scale, zero_point=None, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    v = q.to(dtype)
    if zero_point is not None:
        v = v - torch.as_tensor(zero_point, dtype=dtype, device=v.device)
    return v * torch.as_tensor(scale, dtype=dtype, device=v.device)


def fake_quantize_symmetric(x: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
    """int8 emulated in f32: symmetric quantize then dequantize, per tensor
    or per channel along `axis` (quantnet/core/quantize.py:149-159). The
    oracle an int8 kernel's result is held against: its product equals an f32
    product of fake-quantized operands up to the order of the sum."""
    return quantize_symmetric(x, axis).dequantize()


def fake_quantize_affine(x: torch.Tensor, scale, zero_point) -> torch.Tensor:
    """Affine quantize then dequantize with the given (scale, zero_point),
    in f32 (quantnet/core/quantize.py:162-164)."""
    return dequantize(quantize_affine(x, scale, zero_point), scale, zero_point)


def maybe_requantize(y: torch.Tensor, out_quant) -> torch.Tensor:
    """The int8 tensor-handoff epilogue: requantize `y` into the consumer's
    frozen domain when `out_quant` (an ActQuant) is given, else pass it on."""
    if out_quant is None:
        return y
    return quantize_affine(y, out_quant.scale, out_quant.zero_point)


class _Clip(torch.autograd.Function):
    """clamp(x, lo, hi) with jnp.clip's gradient: 1 inside, 0 outside and
    0.5 at lo or hi, where jnp.clip's max / min split a tie between their
    two operands (torch.clamp passes all of it)."""

    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = ((x > ctx.lo) & (x < ctx.hi)).to(g.dtype)
        edge = ((x == ctx.lo) | (x == ctx.hi)).to(g.dtype)
        return g * (inside + 0.5 * edge), None, None


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi): the same values, and jnp.clip's gradient where
    one is asked for. lo and hi must be f32 values."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Clip.apply(x, lo, hi)
    return torch.clamp(x, lo, hi)


@functools.lru_cache(maxsize=None)
def _act_constants(scale: float, zero_point: int, device: torch.device):
    """A FakeQuant's (scale, zero point) as f32 and int32 0-d tensors on
    `device`, made once; and the STE's clip range (INT8_MIN - zp) * scale,
    (INT8_MAX - zp) * scale, in f32, as host numbers."""
    s, zp = np.float32(scale), np.float32(zero_point)
    lo = float((np.float32(INT8_MIN) - zp) * s)
    hi = float((np.float32(INT8_MAX) - zp) * s)
    return (torch.tensor(s, device=device), torch.tensor(zero_point, dtype=torch.int32, device=device),
            lo, hi)


def fake_quant_act_ste(x: torch.Tensor, scale: float, zero_point: int) -> torch.Tensor:
    """Clipped straight-through affine fake quantization of an activation
    (quantnet/core/quantize.py:166-182): the value is quantize -> dequantize
    in the frozen domain, written as xc + (fq - xc) with xc = clip(x, lo,
    hi), so its floats are the JAX package's; the gradient is clip's (1
    inside the int8 range, 0 outside, 0.5 on its ends)."""
    s, zp, lo, hi = _act_constants(float(scale), int(zero_point), x.device)
    with torch.no_grad():
        fq = fake_quantize_affine(x, s, zp)
    xc = clip(x, lo, hi)
    return xc + (fq - xc.detach())


def fake_quant_weight_ste(
    w: torch.Tensor, per_channel: bool = True, bits: int = 8, group_size: Optional[int] = None,
    *, k: Optional[int] = None, reduce_max: Optional[Callable] = None,
) -> torch.Tensor:
    """Straight-through symmetric fake quantization of a weight
    (quantnet/core/quantize.py:185-211): the scale follows the live weight's
    absmax, per output channel when per_channel, on the grid quantize_weight
    gives (groups along K only for a 2-D weight whose K the group divides),
    so the bake deploys what training simulated. Written w + (fq - w); the
    gradient is the identity.

    A shard of the model axis (parallel/tensor.py) passes the weight's
    global K (`k`: the groups are decided on it, not on the shard's rows,
    which then hold whole groups) and `reduce_max`, through which every
    absmax that the shard's rows do not cover whole is taken."""
    with torch.no_grad():
        rows = w.shape[0] if k is None else k
        if per_channel and group_size is not None and w.ndim == 2 and rows % group_size == 0:
            if w.shape[0] % group_size:
                raise ValueError(f"a shard of {w.shape[0]} rows splits a group of {group_size}")
            fq = quantize_symmetric_grouped(w, group_size, bits=bits).dequantize()
        else:
            fq = quantize_symmetric(w, (w.ndim - 1) if per_channel else None, bits=bits,
                                    reduce_max=reduce_max).dequantize()
        d = fq - w
    return w + d
