"""Inference latency / throughput on the card (counterpart of
quantnet/bench/benchmark.py:283-332).

Timed with CUDA events around each forward after warm-up. There is no CPU
fallback: a measurement without a card raises.
"""
from __future__ import annotations

import statistics
from typing import Callable, Dict

import torch


class InferenceBenchmark:
    """apply_fn(params, state, x) -> (logits, state), on CUDA params."""

    def __init__(
        self,
        *,
        image_size: int = 32,
        channels: int = 3,
        warmup: int = 10,
        iters: int = 50,
        seed: int = 0,
    ):
        self.image_size = image_size
        self.channels = channels
        self.warmup = warmup
        self.iters = max(iters, 1)
        self.seed = seed

    def _input(self, batch_size: int, device) -> torch.Tensor:
        g = torch.Generator().manual_seed(self.seed)
        shape = (batch_size, self.image_size, self.image_size, self.channels)
        return torch.randn(shape, generator=g).to(device)

    def measure(
        self, apply_fn: Callable, params: dict, state: dict, batch_size: int
    ) -> Dict[str, float]:
        """Per-forward latency percentiles and throughput for one batch size."""
        if not torch.cuda.is_available():
            raise RuntimeError("InferenceBenchmark.measure needs a CUDA device")
        device = torch.device("cuda", torch.cuda.current_device())
        x = self._input(batch_size, device)
        for _ in range(self.warmup):
            apply_fn(params, state, x)
        events = [
            (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(self.iters)
        ]
        for start, end in events:
            start.record()
            apply_fn(params, state, x)
            end.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in events)
        p50 = statistics.median(times)
        mean = statistics.fmean(times)
        return {
            "device": torch.cuda.get_device_name(device),
            "batch_size": batch_size,
            "iters": self.iters,
            "p50_ms": p50,
            "mean_ms": mean,
            "min_ms": times[0],
            "max_ms": times[-1],
            "images_per_s_p50": batch_size / (p50 / 1e3),
            "images_per_s": batch_size / (mean / 1e3),
        }
