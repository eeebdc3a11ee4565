"""int8 GEMM with int32 accumulation: the port of int8_matmul_pallas.

`int8_gemm` launches the hand-written CUDA kernel (csrc/int8_gemm.cu) on a
CUDA tensor and runs `int8_gemm_plain` on a CPU tensor; there is no other
route. B is taken as int8[N, K], K contiguous: weights are transposed once at
quantize time (`QTensor.nk`), so both operands stream along K.
"""
from __future__ import annotations

import torch

from quantnet_torch import _build


def int8_gemm_plain(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """int8[M,K] @ int8[N,K]^T -> int32[M,N], exact on any device.

    Every product and partial sum of int8 values is an integer below 2**53 for
    K < 2**38, so a float64 product is exact whatever its summation order
    (CUDA has no integer matmul).
    """
    return (a.double() @ b_nk.double().t()).to(torch.int32)


def _check_operands(a: torch.Tensor, b_nk: torch.Tensor) -> None:
    if a.dtype != torch.int8 or b_nk.dtype != torch.int8:
        raise TypeError(f"int8_gemm takes int8 operands, got {a.dtype} and {b_nk.dtype}")
    if a.ndim != 2 or b_nk.ndim != 2 or a.shape[1] != b_nk.shape[1]:
        raise ValueError(
            f"int8_gemm takes a[M,K] and b[N,K], got {tuple(a.shape)} and {tuple(b_nk.shape)}"
        )
    if a.device != b_nk.device:
        raise ValueError(f"operands on different devices: {a.device} and {b_nk.device}")


def int8_gemm(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """int8[M,K] @ int8[N,K]^T -> int32[M,N], exact.

    CUDA tensors (contiguous) go to the kernel; CPU tensors to the plain
    version. `int8_gemm.launches` counts kernel launches.
    """
    _check_operands(a, b_nk)
    if a.device.type == "cpu":
        return int8_gemm_plain(a, b_nk)
    if a.device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cuda or cpu tensors, got {a.device}")
    if not (a.is_contiguous() and b_nk.is_contiguous()):
        raise ValueError("int8_gemm's kernel takes contiguous operands")
    m, k = a.shape
    n = b_nk.shape[0]
    c = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return c
    fn = _build.kernel("int8_gemm")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b_nk.data_ptr(), c.data_ptr(), m, n, k, stream)
    _build.check(err, "int8_gemm")
    int8_gemm.launches += 1
    return c


int8_gemm.launches = 0
