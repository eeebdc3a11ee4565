"""Dense layer with quantization-aware dispatch (counterpart of
quantnet/ops/linear.py:93-226).

Three paths, picked by the layer's leaves:

  fp32/bf16    w: Tensor                  -> x @ w + b
  dynamic PTQ  w: QTensor, aq dynamic     -> fused kernel, or per-row quant +
                                             int8 GEMM kernel + f32 epilogue
  static PTQ   w: QTensor, aq ActQuant    -> frozen affine quant, int8 GEMM
                                             kernel, - zp * wsum, f32 epilogue

Every path takes `out_quant` and then requantizes its output into that
domain (the int8 handoff; see ops/conv.py). The weight-only and W4A8 paths,
and the probe / QAT branches, come with later slices and raise here.
"""
from __future__ import annotations

from typing import Optional

import torch

from quantnet_torch.core.config import DEFAULT_FLAGS, Flags
from quantnet_torch.core.quantize import dynamic_quantize, maybe_requantize, quantize_affine
from quantnet_torch.core.types import ActQuant, DynamicActQuant, QTensor
from quantnet_torch.ops.fused_dynamic_matmul import (
    fused_dynamic_gemm,
    fused_dynamic_gemm_plain,
)
from quantnet_torch.ops.int8_matmul import int8_gemm, int8_gemm_plain


def apply_act(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation is None:
        return y
    if activation == "relu":
        return torch.relu(y)
    raise ValueError(f"unknown activation {activation!r}")


def int8_matmul(qx: torch.Tensor, w: QTensor, flags: Flags) -> torch.Tensor:
    """int8[M,K] x the weight's int8 (K, N) payload -> int32[M,N]."""
    gemm = int8_gemm_plain if flags.plain else int8_gemm
    return gemm(qx.contiguous(), w.nk())


def _per_column(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.float().reshape(-1).expand(n).contiguous()


def linear(
    layer: dict,
    x: torch.Tensor,
    *,
    activation: Optional[str] = None,
    out_quant: Optional[ActQuant] = None,
    flags: Flags = DEFAULT_FLAGS,
) -> torch.Tensor:
    """Apply a dense layer {'w', optional 'b', 'aq', 'wsum'} to x[M, K]."""
    w = layer["w"]
    b = layer.get("b")
    if not isinstance(w, QTensor):
        # bf16 params pull f32 activations down to bf16; f32 params leave the
        # activations' dtype as it is (the JAX package's narrow-dtype rule).
        cdtype = w.dtype if w.dtype == torch.bfloat16 else x.dtype
        y = torch.matmul(x.to(cdtype), w.to(cdtype)).float()
        if b is not None:
            y = y + b
        return maybe_requantize(apply_act(y, activation), out_quant)

    aq = layer.get("aq")
    if isinstance(aq, DynamicActQuant):
        n = w.values.shape[-1]
        if flags.dynamic_linear == "fused":
            # x goes in as it arrives, f32 or the bf16 handoff of the layer
            # before, as the JAX package feeds it (linear.py:208); the kernel
            # then takes its block scales on bf16 values as the Pallas body does.
            gemm = fused_dynamic_gemm_plain if flags.plain else fused_dynamic_gemm
            bias = b if b is not None else torch.zeros((), device=x.device)
            y = gemm(x.contiguous(), w.nk(), _per_column(w.scale, n), _per_column(bias, n))
            return maybe_requantize(apply_act(y, activation), out_quant)

        # Per-row symmetric activation quant, int8 GEMM, f32 epilogue.
        qx, x_scale = dynamic_quantize(x, axis=0)
        acc = int8_matmul(qx, w, flags)
        y = acc.float() * (x_scale * w.scale)
        if b is not None:
            y = y + b
        y = apply_act(y, activation)
        if aq.handoff is not None and out_quant is None:
            y = y.to(aq.handoff_dtype)
        return maybe_requantize(y, out_quant)

    if isinstance(aq, ActQuant):
        # Static: (qx - zp) @ qw = qx @ qw - zp * colsum(qw), the colsum
        # baked as 'wsum'. W4A8's grouped weights come with a later slice.
        qx = x if x.dtype == torch.int8 else quantize_affine(x, aq.scale, aq.zero_point)
        acc = int8_matmul(qx, w, flags) - aq.zero_point * layer["wsum"]
        y = acc.float() * (aq.scale * w.scale)
        if b is not None:
            y = y + b
        return maybe_requantize(apply_act(y, activation), out_quant)

    raise NotImplementedError(
        "the weight-only quantized linear comes with a later slice; got aq="
        f"{type(aq).__name__}"
    )
