"""Dense layer with quantization-aware dispatch (counterpart of
quantnet/ops/linear.py:93-226).

Four paths, picked by the layer's leaves:

  fp32/bf16    w: Tensor                  -> x @ w + b, f32 accumulation
                                             and result
  weight-only  w: QTensor, no 'aq'        -> (x @ q) * scale (grouped:
                                             x @ dequantize(w))
  dynamic PTQ  w: QTensor, aq dynamic     -> fused kernel with the relu in
                                             its store, or per-row quant +
                                             int8 GEMM kernel with the
                                             epilogue fused into its store
  static PTQ   w: QTensor, aq ActQuant    -> frozen affine quant, int8 GEMM
                                             kernel with - zp * wsum and the
                                             epilogue fused into its store

Every path takes `out_quant` and then requantizes its output into that
domain (the int8 handoff; see ops/conv.py); on the int8 GEMM paths the
kernel stores that int8 output itself. The fp32 / bf16 and weight-only
products run outside Pallas in the JAX package too: here they are PyTorch
products with TF32 off. W4A8's grouped static path and the probe / QAT
branches come with later slices and raise here.
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
from quantnet_torch.ops.macs import record_linear


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


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation and an f32 result, as the JAX package's
    `jnp.dot(..., preferred_element_type=f32)`: bf16 operands are widened to
    f32, where the product of two bf16 values is exact, and multiplied in
    f32 with TF32 off, whatever the caller has set."""
    x, w = x.float(), w.float()
    if not x.is_cuda:
        return torch.matmul(x, w)
    cublas = torch.backends.cuda.matmul
    before = cublas.allow_tf32
    cublas.allow_tf32 = False
    try:
        return torch.matmul(x, w)
    finally:
        cublas.allow_tf32 = before


def needs_gemm_constants(layer: dict) -> bool:
    """Whether a layer runs through the int8 GEMM kernels and so keeps its
    frozen operands under 'gemm': an int8 weight that is not grouped, with
    a dynamic or static activation quant."""
    w = layer.get("w")
    return (
        isinstance(w, QTensor) and w.group_size is None
        and isinstance(layer.get("aq"), (ActQuant, DynamicActQuant))
    )


def with_gemm_constants(node):
    """A params tree whose every layer that needs them (needs_gemm_constants)
    holds its GEMM constants under 'gemm', made here, once: for a tree
    carried over or loaded from an artifact."""
    if not isinstance(node, dict):
        return node
    out = {k: with_gemm_constants(v) for k, v in node.items()}
    if needs_gemm_constants(out):
        out["gemm"] = gemm_constants(out)
    return out


def float_epilogue(y: torch.Tensor, b, activation, out_quant) -> torch.Tensor:
    """+ b, activation and the int8 handoff after an f32 product."""
    if b is not None:
        y = y + b
    return maybe_requantize(apply_act(y, activation), out_quant)


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
    record_linear(x.shape[0], x.shape[1], w.shape[-1])
    if not isinstance(w, QTensor):
        # bf16 params pull f32 activations down to bf16; f32 params leave the
        # activations' dtype as it is (the JAX package's narrow-dtype rule).
        # The product is accumulated and returned in f32 either way.
        cdtype = w.dtype if w.dtype == torch.bfloat16 else x.dtype
        return float_epilogue(matmul_f32(x.to(cdtype), w.to(cdtype)), b, activation, out_quant)

    aq = layer.get("aq")
    if aq is None:
        # Weight-only: the product in the activation dtype, f32 accumulation.
        # A per-channel scale moves past the product, (x @ q) * s; a grouped
        # one varies along K, so the weight is dequantized first.
        if w.group_size is not None:
            y = matmul_f32(x, w.dequantize(x.dtype))
        else:
            y = matmul_f32(x, w.values.to(x.dtype)) * w.scale
        return float_epilogue(y, b, activation, out_quant)

    if w.group_size is not None:
        if isinstance(aq, ActQuant):
            raise NotImplementedError(
                "W4A8's grouped static linear needs a batched int8 GEMM kernel (K1 with "
                "a batch axis over the K groups), which is not ported yet"
            )
        # No kernel takes a (K // g, 1, N) scale on the dynamic path: fail
        # rather than broadcast it into a wrong-shaped output.
        raise NotImplementedError(
            "group-wise quantized weights need a frozen ActQuant (W4A8) or no "
            f"activation quant (weight-only); got {type(aq).__name__}"
        )

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
        # baked as 'wsum'.
        qx = x if x.dtype == torch.int8 else quantize_affine(x, aq.scale, aq.zero_point)
        epi = int8_epilogue(layer, activation=activation, out_quant=out_quant)
        return int8_matmul(qx, layer, flags, epi)

    raise TypeError(f"unsupported activation-quant leaf {type(aq).__name__}")
