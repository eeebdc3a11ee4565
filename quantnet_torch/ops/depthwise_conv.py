"""Depthwise 3x3 int8 convolution with the int8 layers' epilogue fused (K4,
csrc/depthwise_conv.cu).

The JAX package sends grouped int8 convs to XLA's native conv
(quantnet/ops/conv.py:123-128); this kernel takes that work on the card:
NHWC int8 x, HWIO (3, 3, 1, C) int8 w, groups == C, stride 1 or 2, explicit
pads filled with `pad_value` (0 dynamic, the zero point static). Each output
is the int32 sum of nine products, then the `Epilogue` of the int8 GEMM
(ops/int8_matmul.py), applied per channel and bit for bit the same: - zpw,
* cs, + bias, activation, and one store of f32, bf16 or int8. With no
epilogue the kernel stores the int32 accumulator.

`depthwise_conv` launches the kernel on a CUDA tensor and runs
`depthwise_conv_plain` on a CPU tensor; there is no other route.
`depthwise_conv.launches` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from quantnet_torch import _build
from quantnet_torch.ops.int8_matmul import _STORES, ACTS, Epilogue, apply_epilogue

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
KERNEL = (3, 3)


def _out_size(size: int, lo: int, hi: int, k: int, stride: int) -> int:
    return (size + lo + hi - k) // stride + 1


def depthwise_acc_plain(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads,
                        pad_value: int) -> torch.Tensor:
    """int32[N, Ho, Wo, C]: the depthwise conv's accumulator, exact, as the
    sum over the taps of the padded input's shifted slices times the weight
    (no conv library)."""
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x.to(torch.int32).permute(0, 3, 1, 2), (pl, pr, pt, pb), value=int(pad_value))
    xp = xp.permute(0, 2, 3, 1)
    kh, kw = w.shape[0], w.shape[1]
    ho = _out_size(x.shape[1], pt, pb, kh, stride)
    wo = _out_size(x.shape[2], pl, pr, kw, stride)
    wi = w.to(torch.int32)
    acc = torch.zeros((x.shape[0], ho, wo, x.shape[3]), dtype=torch.int32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, i : i + (ho - 1) * stride + 1 : stride, j : j + (wo - 1) * stride + 1 : stride]
            acc += tap * wi[i, j, 0]
    return acc


def depthwise_conv_plain(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads,
                         pad_value: int, epi: Optional[Epilogue] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops, on any device: the accumulator,
    then the int8 GEMM's epilogue per channel (or the accumulator alone)."""
    acc = depthwise_acc_plain(x, w, stride, pads, pad_value)
    return acc if epi is None else apply_epilogue(acc, epi)


def _check(x: torch.Tensor, w: torch.Tensor, stride: int, pad_value: int,
           epi: Optional[Epilogue]) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"depthwise_conv takes int8 x and w, got {x.dtype} and {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or w.shape[2] != 1 or w.shape[3] != x.shape[3]:
        raise ValueError(f"depthwise_conv takes NHWC x and an HWIO (kh, kw, 1, C) weight, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"operands on different devices: {x.device} and {w.device}")
    if stride < 1 or not -128 <= int(pad_value) <= 127:
        raise ValueError(f"stride {stride}, pad value {pad_value}")
    if epi is not None:
        if epi.rs is not None or epi.group is not None:
            raise ValueError("the depthwise conv's epilogue is per channel: no rs, no group")
        epi.check(1, x.shape[3], 9, x)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads, pad_value: int,
                   epi: Optional[Epilogue] = None) -> torch.Tensor:
    """The depthwise conv of int8 NHWC `x` by the int8 (3, 3, 1, C) `w` ->
    epi.out[N, Ho, Wo, C], or int32 without an epilogue: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    _check(x, w, stride, pad_value, epi)
    if x.device.type == "cpu":
        return depthwise_conv_plain(x, w, stride, pads, pad_value, epi)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv runs on cuda or cpu tensors, got {x.device}")
    if tuple(w.shape[:2]) != KERNEL:
        raise ValueError(f"the depthwise conv kernel takes a 3x3 weight, got {tuple(w.shape[:2])}")
    (pt, pb), (pl, pr) = pads
    n, h, wd, c = x.shape
    ho, wo = _out_size(h, pt, pb, 3, stride), _out_size(wd, pl, pr, 3, stride)
    dtype = torch.int32 if epi is None else epi.out
    y = torch.empty((n, max(ho, 0), max(wo, 0), c), dtype=dtype, device=x.device)
    if y.numel() == 0:
        return y
    x, w = x.contiguous(), w.contiguous()
    if epi is None:
        store, ptrs, act, out_s, out_zp = 0, (None,) * 3, 0, 0.0, 0.0
    else:
        store, act = _STORES[epi.out], ACTS[epi.act]
        ptrs = tuple(None if t is None else t.data_ptr() for t in (epi.cs, epi.bias, epi.zpw))
        out_s, out_zp = epi.out_quant.host_scalars() if epi.out_quant is not None else (0.0, 0.0)
    fn = _build.kernel("depthwise_conv")
    dev = x.get_device()
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c, ho, wo, stride, pt, pl,
                 int(pad_value), store, *ptrs, act, out_s, out_zp,
                 torch._C._cuda_getCurrentRawStream(dev))
    _build.check(err, "depthwise_conv")
    depthwise_conv.launches += 1
    return y


depthwise_conv.launches = 0
