"""Dense layer with quantization-aware dispatch (counterpart of
quantnet/ops/linear.py:93-226).

Three paths, picked by the layer's leaves:

  fp32/bf16    w: Tensor                  -> x @ w + b
  dynamic PTQ  w: QTensor, aq dynamic     -> fused kernel with the relu in
                                             its store, or per-row quant +
                                             int8 GEMM kernel with the
                                             epilogue fused into its store
  static PTQ   w: QTensor, aq ActQuant    -> frozen affine quant, int8 GEMM
                                             kernel with - zp * wsum and the
                                             epilogue fused into its store

Every path takes `out_quant` and then requantizes its output into that
domain (the int8 handoff; see ops/conv.py); on the int8 GEMM paths the
kernel stores that int8 output itself. The weight-only and W4A8 paths, and
the probe / QAT branches, come with later slices and raise here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from quantnet_torch.core.config import DEFAULT_FLAGS, Flags
from quantnet_torch.core.quantize import dynamic_quantize, maybe_requantize, quantize_affine
from quantnet_torch.core.types import ActQuant, DynamicActQuant, QTensor
from quantnet_torch.ops.fused_dynamic_matmul import (
    fused_dynamic_gemm,
    fused_dynamic_gemm_plain,
)
from quantnet_torch.ops.int8_matmul import (
    K_ALIGN,
    Epilogue,
    int8_gemm_epilogue,
    int8_gemm_epilogue_plain,
)


def apply_act(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation is None:
        return y
    if activation == "relu":
        return torch.relu(y)
    raise ValueError(f"unknown activation {activation!r}")


def relu_flag(activation: Optional[str]) -> bool:
    """The int8 GEMM epilogue's relu switch for an activation name."""
    if activation not in (None, "relu"):
        raise ValueError(f"unknown activation {activation!r}")
    return activation == "relu"


def _per_column(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.float().reshape(-1).expand(n).contiguous()


@dataclass(frozen=True)
class GemmConstants:
    """A quantized layer's frozen operands of the GEMM kernels, kept in the
    layer under 'gemm'. Made once, where the tree is built (the static bake,
    the dynamic quantize, interop), by `gemm_constants`.

    b_nk:    int8[N, K'], the weight as the int8 GEMM kernel takes it: K
             zero-padded to a multiple of K_ALIGN (the same tensor as
             `w.nk()` where K is one already)
    w_nk:    int8[N, K], the weight as the fused dynamic kernel takes it (a
             dynamic dense layer), else None
    w_scale: f32[N], the weight scale per column
    cs:      f32[N], aq.scale * w.scale (static), else None
    zpw:     int32[N], zero_point * wsum (static), else None
    bias:    f32[N], or None
    """

    b_nk: torch.Tensor
    w_nk: Optional[torch.Tensor]
    w_scale: torch.Tensor
    cs: Optional[torch.Tensor]
    zpw: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]


def gemm_constants(layer: dict) -> GemmConstants:
    """The GEMM constants of a quantized layer {'w' QTensor, 'aq', 'wsum'
    (static), optional 'b'}. Built again if any of those is replaced."""
    w, aq, b = layer["w"], layer["aq"], layer.get("b")
    n = w.values.shape[-1]
    k = w.values.numel() // n
    pad = -k % K_ALIGN
    if pad == 0:
        b_nk = w.nk()
    else:
        b_nk = F.pad(w.values.reshape(k, n).t(), (0, pad)).contiguous()
    dense_dynamic = isinstance(aq, DynamicActQuant) and w.values.ndim == 2
    w_scale = _per_column(w.scale, n)
    cs = zpw = None
    if isinstance(aq, ActQuant):
        cs = _per_column(aq.scale * w.scale, n)
        zpw = (aq.zero_point * layer["wsum"]).to(torch.int32).reshape(-1).expand(n).contiguous()
    return GemmConstants(
        b_nk=b_nk, w_nk=w.nk() if dense_dynamic else None, w_scale=w_scale, cs=cs, zpw=zpw,
        bias=None if b is None else _per_column(b, n),
    )


def _constants(layer: dict) -> GemmConstants:
    g = layer.get("gemm")
    if g is None:
        raise ValueError(
            "a quantized layer needs its GEMM constants under 'gemm': build the tree with "
            "the static bake, the dynamic quantize or interop, or add gemm_constants(layer)"
        )
    return g


def int8_epilogue(
    layer: dict,
    x_scale: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str],
    out_quant: Optional[ActQuant],
    per_row: bool = False,
) -> Epilogue:
    """The int8 GEMM epilogue of a quantized layer: the output is
    acc * (x_scale * w.scale) [- zp * wsum first, static], + b, activation,
    stored as the layer hands it on: int8 in `out_quant`'s domain, else the
    dynamic bf16 handoff, else f32. `per_row`: x_scale is [M, 1] (the
    dynamic linear's per-row quant), else () per tensor."""
    aq, g = layer["aq"], _constants(layer)
    rs = None
    if isinstance(aq, ActQuant):
        cs = g.cs
    elif per_row:
        cs, rs = g.w_scale, x_scale.float().reshape(-1)
    else:
        cs = x_scale.float() * g.w_scale
    if out_quant is not None:
        out = torch.int8
    elif isinstance(aq, DynamicActQuant) and aq.handoff is not None:
        out = aq.handoff_dtype
    else:
        out = torch.float32
    return Epilogue(
        cs=cs, bias=g.bias, zpw=g.zpw, rs=rs, relu=relu_flag(activation), out=out,
        out_quant=out_quant,
    )


def int8_matmul(qx: torch.Tensor, layer: dict, flags: Flags, epi: Epilogue) -> torch.Tensor:
    """int8[M,K] x the layer's int8 weight through the int8 GEMM kernel with
    `epi` fused -> epi.out[M,N]. K is zero-padded to the kernel's K_ALIGN
    (the weight's padded copy is one of the layer's GEMM constants)."""
    b = _constants(layer).b_nk
    if qx.shape[1] != b.shape[1]:
        qx = F.pad(qx, (0, b.shape[1] - qx.shape[1]))
    gemm = int8_gemm_epilogue_plain if flags.plain else int8_gemm_epilogue
    return gemm(qx.contiguous(), b, epi)


def linear(
    layer: dict,
    x: torch.Tensor,
    *,
    activation: Optional[str] = None,
    out_quant: Optional[ActQuant] = None,
    flags: Flags = DEFAULT_FLAGS,
) -> torch.Tensor:
    """Apply a dense layer {'w', optional 'b', 'aq', 'wsum', 'gemm'} to x[M, K]."""
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
            g = _constants(layer)
            bias = g.bias if g.bias is not None else torch.zeros((n,), device=x.device)
            y = gemm(x.contiguous(), g.w_nk, g.w_scale, bias, relu_flag(activation))
            return maybe_requantize(y, out_quant)

        # Per-row symmetric activation quant, int8 GEMM, epilogue in the kernel.
        qx, x_scale = dynamic_quantize(x, axis=0)
        epi = int8_epilogue(layer, x_scale, activation=activation, out_quant=out_quant, per_row=True)
        return int8_matmul(qx, layer, flags, epi)

    if isinstance(aq, ActQuant):
        # Static: (qx - zp) @ qw = qx @ qw - zp * colsum(qw), the colsum
        # baked as 'wsum'. W4A8's grouped weights come with a later slice.
        qx = x if x.dtype == torch.int8 else quantize_affine(x, aq.scale, aq.zero_point)
        epi = int8_epilogue(layer, activation=activation, out_quant=out_quant)
        return int8_matmul(qx, layer, flags, epi)

    raise NotImplementedError(
        "the weight-only quantized linear comes with a later slice; got aq="
        f"{type(aq).__name__}"
    )
