"""Fused dynamic-quant GEMM: the port of dynamic_int8_matmul_fused.

f32 or bf16 x[M,K], int8 w[N,K], f32 w_scale[N], f32 bias[N] -> f32[M,N],
relu applied where the layer has one (fc1's, fused into the kernel's store).
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
runs `fused_dynamic_gemm_plain` on a CPU tensor; there is no other route. The
kernel's TMA loads take x and W in 16-byte-aligned rows of a multiple of 16
bytes: where K does not give that, the wrapper zero-pads K (exact: the zeros
change no absmax and add nothing, and the block rule still reads the
unpadded K).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from quantnet_torch import _build
from quantnet_torch.core.quantize import EPS, SYM_MAX, _mul_reciprocal
from quantnet_torch.ops.int8_matmul import K_ALIGN, int8_gemm_plain

BLOCK_K = 512
# The floor 1e-8 as a bf16 literal, as the Pallas body takes it for bf16 x.
BF16_EPS = float(torch.tensor(EPS, dtype=torch.bfloat16))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def block_k_for(k: int) -> int:
    """The K-block width the JAX kernel uses for a reduction of depth k."""
    return min(BLOCK_K, -(-k // 128) * 128)


def fused_dynamic_gemm_plain(
    x: torch.Tensor,
    w_nk: torch.Tensor,
    w_scale: torch.Tensor,
    bias: torch.Tensor,
    relu: bool = False,
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
    y = acc * w_scale + bias
    return torch.relu(y) if relu else y


def fused_dynamic_cases(m: int, k: int, dtype: torch.dtype, device, seed: int = 5) -> torch.Tensor:
    """x[m, k] for holding the kernel's quantize against the plain version:
    row by row in turn, K-blocks whose quotients x / s fall on the ties of
    the rounding (absmax 127 * 2^e, values at (j + 1/2) s and one ulp
    either side), K-blocks below the 1e-8 floor of the scale, subnormal and
    zero values beside normal ones, a row whose first K-block is zero, a
    K-block with an absmax past 2^60 (the kernel's exact division takes
    another route there), and bf16 values of every exponent below 2."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((m, k), generator=g) * 2.0
    bk = block_k_for(k)
    for r in range(m):
        kind = r % 6
        for k0 in range(0, k, bk):
            blk = x[r, k0 : k0 + bk]
            n = blk.numel()
            if kind == 0:
                amax = 127.0 * 2.0 ** int(torch.randint(-20, 20, (1,), generator=g))
                s = torch.tensor(amax) * torch.tensor(1.0 / SYM_MAX, dtype=torch.float32)
                j = torch.randint(-127, 127, (n,), generator=g).double() + 0.5
                v = (j * s.double()).float()
                off = torch.randint(-1, 2, (n,), generator=g, dtype=torch.int32)
                v = (v.view(torch.int32) + off).view(torch.float32)
                v[0] = amax
                blk.copy_(v)
            elif kind == 1:
                blk.mul_(1e-10)
            elif kind == 2:
                blk.mul_(torch.exp2(torch.randint(-150, 0, (n,), generator=g).float()))
                blk[::3] = 0.0
            elif kind == 3 and k0 == 0:
                blk.zero_()
            elif kind == 4:
                blk.mul_(1e20)
            else:
                bits = (torch.arange(n, dtype=torch.int32) * 7 + r * n) % 0x4000
                v = (bits << 16).view(torch.float32)  # bf16 values below 2, in turn
                v[1::2] *= -1.0
                v[0] = 2.0
                blk.copy_(v)
    return x.to(dtype).to(device)


def _check_operands(x, w_nk, w_scale, bias) -> None:
    """Raises unless the operands fit the kernel's function. Cheap: on the
    serving path it runs on every call."""
    x_dtype = x.dtype
    if (x_dtype != torch.float32 and x_dtype != torch.bfloat16) or w_nk.dtype != torch.int8:
        raise TypeError(
            f"fused_dynamic_gemm takes f32 or bf16 x and int8 w, got {x_dtype}, {w_nk.dtype}"
        )
    xs, wsz = x.shape, w_nk.shape
    if len(xs) != 2 or len(wsz) != 2 or xs[1] != wsz[1]:
        raise ValueError(
            f"fused_dynamic_gemm takes x[M,K] and w[N,K], got {tuple(xs)}, {tuple(wsz)}"
        )
    vec = (wsz[0],)
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != vec:
            raise ValueError(f"{name} must be f32[{wsz[0]}], got {t.dtype}{tuple(t.shape)}")
    dev, cuda = x.get_device(), x.is_cuda  # -1 on the CPU
    for t in (w_nk, w_scale, bias):
        if t.get_device() != dev or t.is_cuda != cuda:
            raise ValueError("fused_dynamic_gemm's operands lie on different devices")


# Per (device, stream): the kernel's workspace (partial planes and the
# counters the blocks of a group share, zero between launches), allocated
# once and grown as needed; and the bytes it needs per (device, M, N, K).
# A launch captured into a CUDA graph takes a workspace of its own instead,
# from the graph's memory pool and zeroed by a node of the graph ahead of
# it: a replay, which may run on another stream than the capture's, then
# shares no workspace with an eager launch, and the pool may hand the
# memory to a later node of the same graph.
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}
_workspace_bytes: Dict[Tuple[int, int, int, int], int] = {}


def _workspace(dev: int, stream: int, m: int, n: int, k: int) -> torch.Tensor:
    key = (dev, m, n, k)
    need = _workspace_bytes.get(key)
    if need is None:
        query = _build.function(
            "fused_dynamic_gemm", "fused_dynamic_gemm_workspace", [ctypes.c_int64] * 4
        )
        query.restype = ctypes.c_int64
        need = query(m, n, k, block_k_for(k))
        if need <= 0:
            raise RuntimeError(f"fused_dynamic_gemm takes no {m}x{k}x{n} product")
        _workspace_bytes[key] = need
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((need,), dtype=torch.uint8, device=torch.device("cuda", dev))
    ws = _workspaces.get((dev, stream))
    if ws is None or ws.numel() < need:
        ws = torch.zeros((need,), dtype=torch.uint8, device=torch.device("cuda", dev))
        _workspaces[(dev, stream)] = ws
    return ws


def _launch(x, w_nk, w_scale, bias, out, relu: bool, block_k: int, dev: int) -> int:
    """One launch on the current (raw) stream of device `dev`, which is the
    current device."""
    m, k = x.shape
    n = w_nk.shape[0]
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = _workspace(dev, stream, m, n, k)
    return _build.kernel("fused_dynamic_gemm")(
        x.data_ptr(), w_nk.data_ptr(), w_scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        m, n, k, w_nk.shape[1], block_k, x.dtype == torch.bfloat16, relu, ws.data_ptr(), stream,
    )


def fused_dynamic_gemm(
    x: torch.Tensor,
    w_nk: torch.Tensor,
    w_scale: torch.Tensor,
    bias: torch.Tensor,
    relu: bool = False,
) -> torch.Tensor:
    """Dynamic-INT8 x @ w * w_scale + bias (then relu, if asked) in one
    kernel on a CUDA tensor; the plain version on a CPU tensor.
    `fused_dynamic_gemm.launches` counts kernel launches."""
    _check_operands(x, w_nk, w_scale, bias)
    if x.is_cpu:
        return fused_dynamic_gemm_plain(x, w_nk, w_scale, bias, relu)
    if not x.is_cuda:
        raise ValueError(f"fused_dynamic_gemm runs on cuda or cpu tensors, got {x.device}")
    if not (x.is_contiguous() and w_nk.is_contiguous() and w_scale.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("fused_dynamic_gemm's kernel takes contiguous operands")
    m, k = x.shape
    out = x.new_empty((m, w_nk.shape[0]), dtype=torch.float32)
    if out.numel() == 0:
        return out
    block_k = block_k_for(k)
    x_pad = -k % (16 // x.element_size())
    if x_pad or x.data_ptr() % 16:
        x = F.pad(x, (0, x_pad))
    w_pad = -k % K_ALIGN
    if w_pad or w_nk.data_ptr() % 16:
        w_nk = F.pad(w_nk, (0, w_pad))
    dev = x.get_device()
    # The raw current device and stream, as int8_gemm's wrapper takes them.
    if dev == torch._C._cuda_getDevice():
        err = _launch(x, w_nk, w_scale, bias, out, relu, block_k, dev)
    else:
        with torch.cuda.device(dev):
            err = _launch(x, w_nk, w_scale, bias, out, relu, block_k, dev)
    if err:
        _build.check(err, "fused_dynamic_gemm")
    fused_dynamic_gemm.launches += 1
    return out


fused_dynamic_gemm.launches = 0
