"""Fused dynamic-quant GEMM: the port of dynamic_int8_matmul_fused.

f32 or bf16 x[M,K], int8 w[N,K], f32 w_scale[N], f32 bias[N] -> f32[M,N].
x is quantized per (row, K-block) inside the kernel, with the JAX kernel's
block rule (quantnet/ops/pallas_matmul.py:166-174): block_k = min(512,
round_up(K, 128)) and K zero-padded to a multiple of it. Keeping that rule is
what makes the result agree with the original for K > 512.

bf16 x is what the dynamic model's fc1 receives (the bf16 handoff of the conv
before it), and the Pallas body then works on bf16 values
(pallas_matmul.py:128-131). Held against that body in interpret mode at
fc1's depth (K = 4096, 8 K-blocks), XLA rounds these steps and no others:
    s  = max(absmax, bf16(1e-8)) * f32(1/127)  f32, not rounded
    q  = clip(round(bf16(x / bf16(s))), -127, 127)
    acc += f32(q @ W_block) * s                 with the f32 s
so the quotient divides by the scale rounded to bf16, while the accumulate
multiplies by the unrounded one (XLA's excess precision between fusions).
The kernel is jitted (pallas_matmul.py:136), and XLA takes the body's
`/ 127.0` as a multiply by the f32 reciprocal, for f32 and bf16 x alike
(held against the interpret-mode kernel: a divide misses the scale of about
4% of rows).
With those steps the port agrees with the original to the last bit but for
two FMA contractions XLA makes on the CPU (acc update, epilogue), which the
port leaves out, as on the f32 path (tests/test_torch_kernels_plain.py).

`fused_dynamic_gemm` launches csrc/fused_dynamic_gemm.cu on a CUDA tensor and
runs `fused_dynamic_gemm_plain` on a CPU tensor; there is no other route.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from quantnet_torch import _build
from quantnet_torch.core.quantize import EPS, SYM_MAX, _mul_reciprocal
from quantnet_torch.ops.int8_matmul import int8_gemm_plain

BLOCK_K = 512
# The floor 1e-8 as a bf16 literal, as the Pallas body takes it for bf16 x.
BF16_EPS = float(torch.tensor(EPS, dtype=torch.bfloat16))


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
    bf16 = x.dtype == torch.bfloat16
    bk = block_k_for(k)
    pk = _round_up(_round_up(k, 128), bk)
    xp = F.pad(x.float(), (0, pk - k))  # bf16 -> f32 is exact
    wp = F.pad(w_nk, (0, pk - k))
    acc = torch.zeros((m, w_nk.shape[0]), dtype=torch.float32, device=x.device)
    for k0 in range(0, pk, bk):
        xb = xp[:, k0 : k0 + bk]
        amax = torch.amax(torch.abs(xb), dim=1, keepdim=True)
        s = _mul_reciprocal(torch.clamp_min(amax, BF16_EPS if bf16 else EPS), SYM_MAX)
        if bf16:
            quot = (xb / s.bfloat16().float()).bfloat16().float()
        else:
            quot = xb / s
        q = torch.clamp(torch.round(quot), -SYM_MAX, SYM_MAX).to(torch.int8)
        part = int8_gemm_plain(q, wp[:, k0 : k0 + bk])
        acc = acc + part.float() * s
    return acc * w_scale + bias


def _check_operands(x, w_nk, w_scale, bias) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or w_nk.dtype != torch.int8:
        raise TypeError(
            f"fused_dynamic_gemm takes f32 or bf16 x and int8 w, got {x.dtype}, {w_nk.dtype}"
        )
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
            out.data_ptr(), m, n, k, block_k_for(k), int(x.dtype == torch.bfloat16), stream,
        )
    _build.check(err, "fused_dynamic_gemm")
    fused_dynamic_gemm.launches += 1
    return out


fused_dynamic_gemm.launches = 0
