"""2-D convolution with quantization-aware dispatch, NHWC / HWIO (counterpart
of quantnet/ops/conv.py:59-136, 139-300).

Two paths, picked by the layer's leaves:

  fp32/bf16    w: Tensor                -> conv in the activation dtype
  dynamic PTQ  w: QTensor, aq dynamic   -> per-tensor quant, zero pre-pad,
                                           im2col, int8 GEMM kernel, f32
                                           epilogue, activation, handoff cast

The int8 conv always lowers through im2col to the int8 GEMM kernel, as the
JAX package does under `int8_conv_backend="im2col"`. The weight-only and
static paths, groups, relu6 and the probe / QAT branches come with later
slices and raise here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from quantnet_torch.core.config import DEFAULT_FLAGS, Flags
from quantnet_torch.core.quantize import dynamic_quantize
from quantnet_torch.core.types import DynamicActQuant, QTensor
from quantnet_torch.ops.linear import apply_act, int8_matmul

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _same_pads(h: int, w: int, kh: int, kw: int, stride: int) -> Pads:
    """XLA SAME padding, stride-aware (explicit so the int8 path can pre-pad
    and still match lax.conv's SAME semantics exactly)."""

    def one(size, k):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return total // 2, total - total // 2

    return one(h, kh), one(w, kw)


def _pad_nhwc(x: torch.Tensor, pads: Pads) -> torch.Tensor:
    (pt, pb), (pl, pr) = pads
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """Patches: [N,H,W,C] -> [N,Ho,Wo,kh*kw*C], patch order (kh, kw, C), which
    matches an HWIO weight reshaped to (kh*kw*C, O). Data movement only."""
    n, h, w, c = x.shape
    ho = (h - kh) // stride + 1
    wo = (w - kw) // stride + 1
    # unfold -> [N, Ho, Wo, C, kh, kw]; bring (kh, kw) ahead of C.
    p = x.unfold(1, kh, stride).unfold(2, kw, stride).permute(0, 1, 2, 4, 5, 3)
    return p.reshape(n, ho, wo, kh * kw * c)


def _int8_conv(
    qx: torch.Tensor, w: QTensor, stride: int, pads: Pads, flags: Flags
) -> torch.Tensor:
    """int8 NHWC conv via zero pre-pad + im2col + the int8 GEMM -> int32."""
    kh, kw, _, co = w.values.shape
    patches = _im2col(_pad_nhwc(qx, pads), kh, kw, stride)
    n, ho, wo, pc = patches.shape
    acc = int8_matmul(patches.reshape(n * ho * wo, pc), w, flags)
    return acc.reshape(n, ho, wo, co)


def conv2d(
    layer: dict,
    x: torch.Tensor,
    *,
    stride: int = 1,
    padding: str = "SAME",
    activation: Optional[str] = None,
    flags: Flags = DEFAULT_FLAGS,
) -> torch.Tensor:
    """Apply a conv layer {'w' (HWIO), optional 'b', optional 'aq'} to NHWC x."""
    w = layer["w"]
    b = layer.get("b")
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        pads = _same_pads(x.shape[1], x.shape[2], kh, kw, stride)
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")

    if not isinstance(w, QTensor):
        cdtype = w.dtype if w.dtype == torch.bfloat16 else x.dtype
        xp = _pad_nhwc(x.to(cdtype), pads).permute(0, 3, 1, 2)
        y = F.conv2d(xp, w.to(cdtype).permute(3, 2, 0, 1), stride=stride)
        y = y.permute(0, 2, 3, 1).float()
        if b is not None:
            y = y + b
        return apply_act(y, activation)

    aq = layer.get("aq")
    if not isinstance(aq, DynamicActQuant):
        raise NotImplementedError(
            "only the dynamic-INT8 quantized conv is ported so far; got aq="
            f"{type(aq).__name__}"
        )
    # Symmetric per-batch quant: the f32 zero is the int8 zero, so pad with 0.
    qx, x_scale = dynamic_quantize(x, axis=None)
    acc = _int8_conv(qx, w, stride, pads, flags)
    y = acc.float() * (x_scale * w.scale)
    if b is not None:
        y = y + b
    y = apply_act(y, activation)
    if aq.handoff is not None:
        y = y.to(aq.handoff_dtype)
    return y
