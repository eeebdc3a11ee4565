"""Kernel launches and device time read from a device trace (torch.profiler).

A CUDA graph's replay launches the kernels its capture recorded without
calling the wrappers in quantnet_torch/ops, so the wrappers' `launches`
counts do not see it; the trace does. `kernel_launches` counts the port's
kernels in a trace by their CUDA function's name. Needs a card.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import torch

# Wrapper name -> the __global__ function it launches (quantnet_torch/csrc).
KERNELS = {
    "int8_gemm": "int8_gemm_kernel",
    "fused_dynamic_gemm": "fused_dynamic_gemm_kernel",
    "residual_boundary": "residual_boundary_kernel",
    "depthwise_conv": "depthwise_kernel",
}
_PATTERNS = {name: re.compile(rf"(?<!\w){fn}(?!\w)") for name, fn in KERNELS.items()}


def trace(fn: Callable) -> Tuple[object, "torch.profiler.profile"]:
    """Run fn() under torch.profiler (CPU and CUDA activity), the card
    synchronized before the trace ends -> (fn's result, the profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def device_rows(prof) -> List:
    """The trace's device kernels and copies, summed by name, longest first."""
    rows = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    return sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)


def kernel_launches(prof) -> Dict[str, int]:
    """Launches of each of the port's kernels that ran on the card in the
    trace, by wrapper name."""
    counts = dict.fromkeys(KERNELS, 0)
    for e in device_rows(prof):
        for name, pattern in _PATTERNS.items():
            if pattern.search(e.key):
                counts[name] += e.count
    return counts
