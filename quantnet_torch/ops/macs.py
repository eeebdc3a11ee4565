"""Multiply-accumulates of the conv and dense layers a forward runs.

`conv2d` and `linear` report each call's MACs here while a `counting_macs()`
block is open (bench/benchmark.py::estimate_flops). The count comes from the
call's shapes, so it is the model's work, the same under every scheme, and
not that of its lowering (im2col's padded K, the zero-point pre-pad).
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Iterator, List, Optional

_COUNTS: ContextVar[Optional[List[int]]] = ContextVar("quantnet_torch_macs", default=None)


@contextlib.contextmanager
def counting_macs() -> Iterator[List[int]]:
    """Collects the MACs of every conv and dense call inside the block."""
    counts: List[int] = []
    token = _COUNTS.set(counts)
    try:
        yield counts
    finally:
        _COUNTS.reset(token)


def conv_dim_taps(out_size: int, k: int, stride: int, pad_lo: int, in_size: int) -> int:
    """Kernel taps that land inside the input, summed over the output
    positions of one spatial dim: a tap on padding multiplies a zero and is
    not counted (quantnet/bench/benchmark.py:153-164)."""
    total = 0
    for j in range(k):
        off = j - pad_lo
        lo = max(0, (-off + stride - 1) // stride) if off < 0 else 0
        hi = min(out_size, (in_size - off + stride - 1) // stride)
        total += max(hi - lo, 0)
    return total


def record_conv(x_shape, w_shape, stride: int, pads) -> None:
    """An NHWC conv of x_shape by an HWIO kernel, SAME / VALID / explicit pads."""
    counts = _COUNTS.get()
    if counts is None:
        return
    n, h, w, _ = x_shape
    kh, kw, cin, cout = w_shape
    (pt, pb), (pl, pr) = pads
    ho = (h + pt + pb - kh) // stride + 1
    wo = (w + pl + pr - kw) // stride + 1
    counts.append(n * cout * cin * conv_dim_taps(ho, kh, stride, pt, h)
                  * conv_dim_taps(wo, kw, stride, pl, w))


def record_linear(m: int, k: int, n: int) -> None:
    counts = _COUNTS.get()
    if counts is not None:
        counts.append(m * k * n)
