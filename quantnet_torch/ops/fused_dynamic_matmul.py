"""Fused dynamic-quant GEMM: the port of dynamic_int8_matmul_fused.

f32 x[M,K], int8 w[N,K], f32 w_scale[N], f32 bias[N] -> f32[M,N]. x is
quantized per (row, K-block) inside the kernel, with the JAX kernel's block
rule (quantnet/ops/pallas_matmul.py:166-174): block_k = min(512,
round_up(K, 128)) and K zero-padded to a multiple of it. Keeping that rule is
what makes the result agree with the original for K > 512.

`fused_dynamic_gemm` launches csrc/fused_dynamic_gemm.cu on a CUDA tensor and
runs `fused_dynamic_gemm_plain` on a CPU tensor; there is no other route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from quantnet_torch import _build
from quantnet_torch.core.quantize import EPS, SYM_MAX, _div
from quantnet_torch.ops.int8_matmul import int8_gemm_plain

BLOCK_K = 512


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def block_k_for(k: int) -> int:
    """The K-block width the JAX kernel uses for a reduction of depth k."""
    return min(BLOCK_K, _round_up(k, 128))


def fused_dynamic_gemm_plain(
    x: torch.Tensor, w_nk: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """The kernel's arithmetic written out, one K-block at a time."""
    m, k = x.shape
    bk = block_k_for(k)
    pk = _round_up(_round_up(k, 128), bk)
    xp = F.pad(x, (0, pk - k))
    wp = F.pad(w_nk, (0, pk - k))
    acc = torch.zeros((m, w_nk.shape[0]), dtype=torch.float32, device=x.device)
    for k0 in range(0, pk, bk):
        xb = xp[:, k0 : k0 + bk]
        amax = torch.amax(torch.abs(xb), dim=1, keepdim=True)
        s = _div(torch.clamp_min(amax, EPS), SYM_MAX)
        q = torch.clamp(torch.round(xb / s), -SYM_MAX, SYM_MAX).to(torch.int8)
        part = int8_gemm_plain(q, wp[:, k0 : k0 + bk])
        acc = acc + part.float() * s
    return acc * w_scale + bias


def _check_operands(x, w_nk, w_scale, bias) -> None:
    if x.dtype != torch.float32 or w_nk.dtype != torch.int8:
        raise TypeError(f"fused_dynamic_gemm takes f32 x and int8 w, got {x.dtype}, {w_nk.dtype}")
    if x.ndim != 2 or w_nk.ndim != 2 or x.shape[1] != w_nk.shape[1]:
        raise ValueError(
            f"fused_dynamic_gemm takes x[M,K] and w[N,K], got {tuple(x.shape)}, {tuple(w_nk.shape)}"
        )
    n = w_nk.shape[0]
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be f32[{n}], got {t.dtype}{tuple(t.shape)}")
    if len({t.device for t in (x, w_nk, w_scale, bias)}) != 1:
        raise ValueError("fused_dynamic_gemm's operands lie on different devices")


def fused_dynamic_gemm(
    x: torch.Tensor, w_nk: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Dynamic-INT8 x @ w * w_scale + bias in one kernel on a CUDA tensor; the
    plain version on a CPU tensor. `fused_dynamic_gemm.launches` counts kernel
    launches."""
    _check_operands(x, w_nk, w_scale, bias)
    if x.device.type == "cpu":
        return fused_dynamic_gemm_plain(x, w_nk, w_scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dynamic_gemm runs on cuda or cpu tensors, got {x.device}")
    if not all(t.is_contiguous() for t in (x, w_nk, w_scale, bias)):
        raise ValueError("fused_dynamic_gemm's kernel takes contiguous operands")
    m, k = x.shape
    n = w_nk.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.kernel("fused_dynamic_gemm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), w_nk.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), m, n, k, block_k_for(k), stream,
        )
    _build.check(err, "fused_dynamic_gemm")
    fused_dynamic_gemm.launches += 1
    return out


fused_dynamic_gemm.launches = 0
