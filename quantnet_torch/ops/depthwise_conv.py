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
`depthwise_conv.launches` counts kernel launches. `depthwise_plan` is the
launch's geometry, which the wrapper passes to the kernel and the kernel
checks against the shape.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from quantnet_torch import _build
from quantnet_torch.ops.int8_matmul import _STORES, ACTS, Epilogue, apply_epilogue

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
KERNEL = (3, 3)
STRIDES = (1, 2)  # the kernel's

# The kernel's fixed shape (csrc/depthwise_conv.cu): a thread owns QUAD
# channels and a strip of STRIP output columns; a block has at most THREADS
# threads and, for three blocks a SM (the kernel's launch bound), a staged
# window of at most SMEM_BUDGET bytes (SMEM_MAX is a block's limit on an
# H100; an SM has 228 KB, 1 KB of it reserved a block).
STRIP = 4
QUAD = 4
BAND_ROWS = 7  # MobileNetV2's output heights at 224x224 are 7 * 2^k
THREADS = 256
SMEM_BUDGET = 72 * 1024
SMEM_MAX = 227 * 1024


def _out_size(size: int, lo: int, hi: int, k: int, stride: int) -> int:
    return (size + lo + hi - k) // stride + 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class DepthwisePlan:
    """A launch's geometry. A block of `threads` owns one image, `band_rows`
    output rows, `groups` strips of `strip` output columns and `chunk`
    channels, and stages its input window (`rows_in` x `cols_in` pixels of
    `pitch` bytes, `smem_bytes` in all) in shared memory; a thread owns QUAD
    channels of one strip. The grid is images x chunks x column blocks x
    bands, bands fastest. `vec`: the 16-byte variant (C % 16 == 0, aligned
    pointers), else the masked one."""

    band_rows: int
    strip: int
    chunk: int
    groups: int
    threads: int
    smem_bytes: int
    grid: int
    bands: int
    col_blocks: int
    chunks: int
    rows_in: int
    cols_in: int
    pitch: int
    vec: bool


@functools.lru_cache(maxsize=1024)
def depthwise_plan(n: int, ho: int, wo: int, c: int, stride: int, vec: bool = True, *,
                   threads: int = THREADS, smem_budget: int = SMEM_BUDGET,
                   band_rows: int = BAND_ROWS) -> DepthwisePlan:
    """The launch geometry of the depthwise conv kernel for an [n, ho, wo, c]
    output at `stride`: as many threads a block as the channels and the
    strips of a block give (at most `threads`), the tallest band (at most
    `band_rows`) whose window fits `smem_budget`, column blocks evened out.
    Chunks divide C where a divisor is at least half as wide as the evened
    chunk, and start on 32-byte L2 sectors where C allows it: a chunk that
    starts inside a sector makes two blocks fetch that sector (PERF.md §6,
    MobileNetV2's 112x112x96 stride-2 conv). The keywords are the kernel's
    bounds; tests lower them to cut small shapes into many blocks. Cached:
    the wrapper asks at every call."""
    if stride not in STRIDES:
        raise ValueError(f"the depthwise conv kernel takes stride 1 or 2, got {stride}")
    # Channels a chunk is a multiple of: whole sectors, or the staging's
    # 16-byte units, or (masked) whole quads.
    unit = (32 if c % 32 == 0 else 16) if vec else QUAD
    step = unit // QUAD  # quads a unit
    ng = _cdiv(wo, STRIP)
    groups = min(ng, max(1, threads // step))
    while True:
        col_blocks = _cdiv(ng, groups)
        groups = _cdiv(ng, col_blocks)
        cols_in = (STRIP * groups - 1) * stride + 3
        quads = max(step, threads // groups // step * step)
        chunk = min(QUAD * quads, _cdiv(c, unit) * unit)
        while True:
            chunks = _cdiv(c, chunk)
            even = _cdiv(_cdiv(c, chunks), unit) * unit
            divisor = next((k for k in range(chunk // unit * unit, 0, -unit) if c % k == 0), 0)
            chunk = divisor if 2 * divisor >= even else even
            chunks = _cdiv(c, chunk)
            pitch = _cdiv(chunk, 16) * 16
            for band in range(min(band_rows, ho), 0, -1):
                rows_in = (band - 1) * stride + 3
                smem = rows_in * cols_in * pitch
                if smem <= smem_budget:
                    return DepthwisePlan(
                        band_rows=band, strip=STRIP, chunk=chunk, groups=groups,
                        threads=_cdiv(chunk // QUAD * groups, 32) * 32, smem_bytes=smem,
                        grid=n * chunks * _cdiv(ho, band) * col_blocks, bands=_cdiv(ho, band),
                        col_blocks=col_blocks, chunks=chunks, rows_in=rows_in, cols_in=cols_in,
                        pitch=pitch, vec=vec)
            if chunk == unit:
                break
            chunk = max(unit, chunk // 2 // unit * unit)
        if groups == 1:
            raise ValueError(f"no depthwise plan fits {smem_budget} bytes of shared memory: "
                             f"output {n}x{ho}x{wo}x{c}, stride {stride}")
        groups = _cdiv(groups, 2)


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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, y))
    plan = depthwise_plan(n, ho, wo, c, stride, vec=c % 16 == 0 and aligned)
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
                 int(pad_value), store, *ptrs, act, out_s, out_zp, plan.band_rows, plan.strip,
                 plan.chunk, plan.groups, plan.threads, plan.smem_bytes, plan.grid, int(plan.vec),
                 torch._C._cuda_getCurrentRawStream(dev))
    _build.check(err, "depthwise_conv")
    depthwise_conv.launches += 1
    return y


depthwise_conv.launches = 0
