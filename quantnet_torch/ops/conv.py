"""2-D convolution with quantization-aware dispatch, NHWC / HWIO (counterpart
of quantnet/ops/conv.py:59-136, 139-300).

Four paths, picked by the layer's leaves:

  fp32/bf16    w: Tensor                -> conv in the activation dtype
                                           (bf16 weights pull it to bf16),
                                           f32 accumulation and result
  weight-only  w: QTensor, no 'aq'      -> conv of x and the int8 values,
                                           per-channel scale after it
  dynamic PTQ  w: QTensor, aq dynamic   -> per-tensor quant, zero pre-pad,
                                           im2col, int8 GEMM kernel with the
                                           epilogue (scale, bias, activation,
                                           handoff) fused into its store
  static PTQ   w: QTensor, aq ActQuant  -> frozen affine quant (or int8 input
                                           already in this layer's domain),
                                           zero-point pre-pad, im2col, int8
                                           GEMM kernel with - zp * wsum and
                                           the epilogue fused into its store

Every path takes `out_quant` (the consumer's ActQuant) and then requantizes
its output to int8 in that domain: the static int8 tensor handoff, which the
int8 kernels store themselves. The int8 conv lowers through im2col to the
int8 GEMM kernel, as the JAX package does under `int8_conv_backend="im2col"`;
a depthwise conv (`groups` == C, HWIO kernel (kh, kw, 1, C)), which the JAX
package leaves to XLA's native grouped conv (quantnet/ops/conv.py:123-128),
runs the depthwise int8 conv kernel (ops/depthwise_conv.py) with the same
epilogue. The fp32 / bf16 and weight-only convs run outside Pallas in the JAX
package too: here they are cuDNN convs in f32 with TF32 off, grouped where
asked. Grouped convs that are not depthwise, and group-wise quantized conv
weights, raise, as in the JAX package. Activations: relu and relu6
(MobileNetV2's clipped relu, `jnp.clip(y, 0, 6)`).

A float layer that carries a `ProbeGate` under 'probe' (the sensitivity
sweep, quantize/policy.py) runs the lane its gate picks
(ops/linear.py::probe_lane) through this same dispatch, as
quantnet/ops/conv.py:171-195 does: on the card the quantized lane of a conv
is K1's f32 store, of a depthwise conv K4's. A float layer that carries a
`FakeQuant` under 'fq' (a QAT training island, quantize/qat.py) convolves
its fake-quantized input and weight in f32, groups included, and is
differentiable (quantnet/ops/conv.py:196-225); the train step holds TF32
off for its backward too (core/config.py::no_tf32).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from quantnet_torch.core.config import DEFAULT_FLAGS, Flags
from quantnet_torch.core.quantize import (
    dynamic_quantize,
    fake_quant_act_ste,
    fake_quant_weight_ste,
    maybe_requantize,
    quantize_affine,
)
from quantnet_torch.core.types import ActQuant, DynamicActQuant, QTensor
from quantnet_torch.ops.depthwise_conv import depthwise_conv, depthwise_conv_plain
from quantnet_torch.ops.int8_matmul import K_ALIGN, Epilogue
from quantnet_torch.ops.linear import float_epilogue, int8_epilogue, int8_matmul, probe_lane
from quantnet_torch.ops.macs import record_conv

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
Padding = Union[str, Pads]


def _same_pads(h: int, w: int, kh: int, kw: int, stride: int) -> Pads:
    """XLA SAME padding, stride-aware (explicit so the int8 path can pre-pad
    and still match lax.conv's SAME semantics exactly)."""

    def one(size, k):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return total // 2, total - total // 2

    return one(h, kh), one(w, kw)


def _pad_nhwc(x: torch.Tensor, pads: Pads, value: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pad H and W with zeros, or with `value` (a 0-d tensor of x's dtype,
    the zero point on the static path; read on the device, no host sync)."""
    (pt, pb), (pl, pr) = pads
    if not any((pt, pb, pl, pr)):
        return x  # VALID: no copy (every 1x1 conv)
    if value is None:
        return F.pad(x, (0, 0, pl, pr, pt, pb))
    n, h, w, c = x.shape
    out = value.reshape(1, 1, 1, 1).expand(n, h + pt + pb, w + pl + pr, c).contiguous()
    out[:, pt : pt + h, pl : pl + w] = x
    return out


def _resolve_pads(padding: Padding, h: int, w: int, kh: int, kw: int, stride: int) -> Pads:
    if padding == "SAME":
        return _same_pads(h, w, kh, kw, stride)
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if isinstance(padding, str):
        raise ValueError(f"padding must be 'SAME', 'VALID' or explicit pads, got {padding!r}")
    (pt, pb), (pl, pr) = padding
    return ((int(pt), int(pb)), (int(pl), int(pr)))


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, k_multiple: int = 1) -> torch.Tensor:
    """Patches: [N,H,W,C] -> [N,Ho,Wo,K'], patch order (kh, kw, C), which
    matches an HWIO weight reshaped to (kh*kw*C, O); K = kh*kw*C, zero-padded
    in the same copy to K' = a multiple of `k_multiple` (the int8 GEMM
    kernel's K_ALIGN). Data movement only."""
    n, h, w, c = x.shape
    ho = (h - kh) // stride + 1
    wo = (w - kw) // stride + 1
    k = kh * kw * c
    # unfold -> [N, Ho, Wo, C, kh, kw]; bring (kh, kw) ahead of C.
    p = x.unfold(1, kh, stride).unfold(2, kw, stride).permute(0, 1, 2, 4, 5, 3)
    pad = -k % k_multiple
    if pad == 0:
        return p.reshape(n, ho, wo, k)
    out = x.new_empty((n, ho, wo, k + pad))
    out[..., k:] = 0
    out[..., :k].unflatten(-1, (kh, kw, c)).copy_(p)
    return out


def _conv_no_tf32(x: torch.Tensor, w: torch.Tensor, stride: int, groups: int = 1) -> torch.Tensor:
    """F.conv2d with f32 kept f32: cuDNN takes f32 convs in TF32 by default,
    which keeps about three decimal digits; the JAX package's f32 conv (an
    fp32 stem under skip_first_layer) does not round its operands. PyTorch's
    scoped `cudnn.flags` holds TF32 off for this call only; the caller's
    other cuDNN settings are passed through unchanged."""
    if not x.is_cuda:
        return F.conv2d(x, w, stride=stride, groups=groups)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     benchmark_limit=cudnn.benchmark_limit,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x, w, stride=stride, groups=groups)


def _conv_f32(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads, groups: int = 1) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC f32: the JAX package's conv with
    `preferred_element_type=f32` (and `feature_group_count=groups`). bf16
    operands are widened to f32, where their products are exact, and the
    conv runs in f32 with TF32 off."""
    xp = _pad_nhwc(x.float(), pads).permute(0, 3, 1, 2)
    y = _conv_no_tf32(xp, w.float().permute(3, 2, 0, 1), stride, groups)
    return y.permute(0, 2, 3, 1)


def _int8_conv(
    qx: torch.Tensor,
    layer: dict,
    stride: int,
    pads: Pads,
    flags: Flags,
    epi: Epilogue,
    pad_value: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int8 NHWC conv via pre-pad (0, or the zero point) + im2col + the int8
    GEMM kernel with `epi` fused -> [N, Ho, Wo, O] of epi.out."""
    kh, kw, _, co = layer["w"].shape
    patches = _im2col(_pad_nhwc(qx, pads, pad_value), kh, kw, stride, K_ALIGN)
    n, ho, wo, pc = patches.shape
    y = int8_matmul(patches.reshape(n * ho * wo, pc), layer, flags, epi)
    return y.reshape(n, ho, wo, co)


def _int8_depthwise(
    qx: torch.Tensor,
    layer: dict,
    stride: int,
    pads: Pads,
    flags: Flags,
    epi: Epilogue,
    pad_value: int = 0,
) -> torch.Tensor:
    """int8 NHWC depthwise conv through the depthwise conv kernel with `epi`
    fused -> [N, Ho, Wo, C] of epi.out; the padding is the kernel's own. A
    packed 4-bit weight (9 x C values) is widened into a transient int8
    tensor for the launch."""
    conv = depthwise_conv_plain if flags.plain else depthwise_conv
    return conv(qx.contiguous(), layer["w"].int8_values(), stride, pads, pad_value, epi)


def _check_groups(groups: int, x_shape, w_shape) -> None:
    """groups 1, or a depthwise conv: groups == C, an HWIO (kh, kw, 1, C) kernel."""
    if groups == 1:
        return
    if not (groups == x_shape[-1] and w_shape[2] == 1 and w_shape[3] == x_shape[-1]):
        raise NotImplementedError(
            f"grouped convs other than depthwise are not supported (no model uses them): "
            f"groups {groups} over {x_shape[-1]} input channels, kernel {tuple(w_shape)}; a "
            "depthwise conv has groups == C and an HWIO (kh, kw, 1, C) kernel"
        )


def conv2d(
    layer: dict,
    x: torch.Tensor,
    *,
    stride: int = 1,
    padding: Padding = "SAME",
    activation: Optional[str] = None,
    out_quant: Optional[ActQuant] = None,
    groups: int = 1,
    flags: Flags = DEFAULT_FLAGS,
) -> torch.Tensor:
    """Apply a conv layer {'w' (HWIO), optional 'b', 'aq', 'wsum', 'gemm', 'probe', 'fq'} to NHWC x.

    padding: "SAME" (XLA's, asymmetric at stride 2), "VALID", or explicit
    ((top, bottom), (left, right)), as the ResNet's `torch_pad` passes it.
    groups: 1, or C for a depthwise conv (HWIO kernel (kh, kw, 1, C)); a
    call-site argument, as in the JAX package, never stored in the layer.
    """
    w = layer["w"]
    b = layer.get("b")
    if layer.get("probe") is not None and not isinstance(w, QTensor):
        y = conv2d(probe_lane(layer), x, stride=stride, padding=padding, activation=activation,
                   groups=groups, flags=flags)
        return maybe_requantize(y, out_quant)
    kh, kw = w.shape[0], w.shape[1]
    _check_groups(groups, x.shape, w.shape)
    pads = _resolve_pads(padding, x.shape[1], x.shape[2], kh, kw, stride)
    record_conv(x.shape, w.shape, stride, pads)

    fq = layer.get("fq")
    if fq is not None and not isinstance(w, QTensor):
        # QAT: the deployed static INT8 conv simulated in f32 (the input in
        # its frozen domain unless weight-only, the weight on its grid).
        xq = fake_quant_act_ste(x, fq.scale, fq.zero_point) if fq.act_quant else x
        wq = fake_quant_weight_ste(w, fq.per_channel, fq.weight_bits, fq.weight_group_size)
        return float_epilogue(_conv_f32(xq, wq, stride, pads, groups), b, activation, out_quant)

    if not isinstance(w, QTensor):
        # The narrow-dtype rule of ops/linear.py: bf16 params pull the
        # activations down to bf16; the conv accumulates and returns f32.
        cdtype = w.dtype if w.dtype == torch.bfloat16 else x.dtype
        y = _conv_f32(x.to(cdtype), w.to(cdtype), stride, pads, groups)
        return float_epilogue(y, b, activation, out_quant)

    if w.group_size is not None:
        # A conv cannot split its reduction per group; quantize_weight never
        # groups a 4-D kernel, so only a tree built by hand gets here.
        raise NotImplementedError(
            "group-wise quantized conv weights are unsupported; use per-channel "
            "(quantize_weight groups 2-D weights only)"
        )

    aq = layer.get("aq")
    if aq is None:
        # Weight-only: the conv in the activation dtype with f32 accumulation,
        # the per-channel scale after it.
        # (a packed 4-bit payload widened in torch ops, as XLA converts it)
        y = _conv_f32(x, w.int8_values().to(x.dtype), stride, pads, groups) * w.scale
        return float_epilogue(y, b, activation, out_quant)

    if isinstance(aq, DynamicActQuant):
        # Symmetric per-batch quant: the f32 zero is the int8 zero, so pad with 0.
        qx, x_scale = dynamic_quantize(x, axis=None)
        epi = int8_epilogue(layer, x_scale, activation=activation, out_quant=out_quant)
        if groups > 1:
            return _int8_depthwise(qx, layer, stride, pads, flags, epi)
        return _int8_conv(qx, layer, stride, pads, flags, epi)

    if isinstance(aq, ActQuant):
        # int8 input is already in this layer's domain (its producer
        # requantized into it); the f32 zero is the zero point, so pad with it.
        qx = x if x.dtype == torch.int8 else quantize_affine(x, aq.scale, aq.zero_point)
        epi = int8_epilogue(layer, activation=activation, out_quant=out_quant)
        if groups > 1:
            # The kernel takes the pad value by value: the frozen zero point's
            # host copy, read once.
            return _int8_depthwise(qx, layer, stride, pads, flags, epi, int(aq.host_scalars()[1]))
        return _int8_conv(qx, layer, stride, pads, flags, epi, aq.zero_point.to(torch.int8))

    raise TypeError(f"unsupported activation-quant leaf {type(aq).__name__}")
