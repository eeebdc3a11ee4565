"""Inference latency, throughput, roofline and model size on the card
(counterpart of quantnet/bench/benchmark.py:121-369).

Timed with CUDA events around each forward after warm-up. There is no CPU
fallback: a measurement without a card raises. Asked for the CPU
(`device="cpu"`, a tiny pipeline's test) it times with the host clock and
names the device "cpu"; such a figure is the CPU's, never the card's.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Sequence

import torch

from quantnet_torch.core.types import ActQuant, DynamicActQuant, tree_nbytes
from quantnet_torch.ops.macs import counting_macs

# Peak rates by device name and the compute dtype of the tree, in TOP/s:
# the NVIDIA H100 SXM data sheet, dense (no sparsity). The fp32 products run
# with TF32 off, so an fp32 or weight-only tree is held to the fp32 peak
# outside the tensor cores. A card not listed gets no `mfu`.
PEAK_TOPS = {
    "NVIDIA H100 80GB HBM3": {"int8": 1979.0, "bfloat16": 989.4, "float32": 66.9},
}


def compute_dtype(params: dict) -> str:
    """'int8' when any layer quantizes its input (dynamic or static), else
    'bfloat16' when any weight is bf16, else 'float32' (fp32 and weight-only
    trees multiply in f32)."""
    found = set()

    def walk(node):
        if isinstance(node, dict):
            if isinstance(node.get("aq"), (ActQuant, DynamicActQuant)):
                found.add("int8")
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16:
                found.add("bfloat16")
            for v in node.values():
                walk(v)

    walk(params)
    for dtype in ("int8", "bfloat16"):
        if dtype in found:
            return dtype
    return "float32"


@torch.no_grad()
def estimate_flops(apply_fn: Callable, params: dict, state: dict, x: torch.Tensor) -> float:
    """2 x the MACs of every conv and dense layer of one forward at x's
    batch, from the layers' shapes, counting in-bounds kernel taps only (the
    rule of the JAX package's jaxpr walk). Runs the forward once."""
    with counting_macs() as macs:
        apply_fn(params, state, x)
    return 2.0 * sum(macs)


def roofline_fields(params: dict, flops: float, mean_ms: float, device_name: str) -> Dict[str, float]:
    """model_gops, achieved_tops and, on a card in PEAK_TOPS, peak_tops and
    mfu (achieved over the peak for the tree's compute dtype)."""
    if not flops or mean_ms <= 0:
        return {}
    achieved = flops / (mean_ms / 1e3) / 1e12
    out = {"model_gops": flops / 1e9, "achieved_tops": achieved}
    peaks = PEAK_TOPS.get(device_name)
    if peaks is not None:
        out["peak_tops"] = peaks[compute_dtype(params)]
        out["mfu"] = achieved / out["peak_tops"]
    return out


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's memory: tensors allocated now and at peak, and the card's
    total, in MiB."""
    stats = torch.cuda.memory_stats(device)
    mib = 1024 * 1024
    return {
        "mb_in_use": stats.get("allocated_bytes.all.current", 0) / mib,
        "peak_mb_in_use": stats.get("allocated_bytes.all.peak", 0) / mib,
        "mb_limit": torch.cuda.get_device_properties(device).total_memory / mib,
    }


def _cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("InferenceBenchmark needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


class InferenceBenchmark:
    """apply_fn(params, state, x) -> (logits, state), params on `device`
    (the card by default)."""

    def __init__(
        self,
        *,
        image_size: int = 32,
        channels: int = 3,
        warmup: int = 10,
        iters: int = 50,
        seed: int = 0,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.image_size = image_size
        self.channels = channels
        self.warmup = max(warmup, 1)
        self.iters = max(iters, 1)
        self.seed = seed

    def _device(self) -> torch.device:
        return self.device if self.device.type == "cpu" else _cuda_device()

    def _times_ms(self, apply_fn, params, state, x) -> list:
        """Each of `iters` forwards' ms: CUDA events on the card, the host
        clock on the CPU."""
        if x.device.type == "cpu":
            times = []
            for _ in range(self.iters):
                t0 = time.perf_counter()
                apply_fn(params, state, x)
                times.append((time.perf_counter() - t0) * 1e3)
            return times
        events = [
            (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(self.iters)
        ]
        for start, end in events:
            start.record()
            apply_fn(params, state, x)
            end.record()
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in events]

    def _input(self, batch_size: int, device) -> torch.Tensor:
        g = torch.Generator().manual_seed(self.seed)
        shape = (batch_size, self.image_size, self.image_size, self.channels)
        return torch.randn(shape, generator=g).to(device)

    def measure(
        self, apply_fn: Callable, params: dict, state: dict, batch_size: int
    ) -> Dict[str, float]:
        """Per-forward latency percentiles, throughput and roofline fields
        for one batch size. The first warm-up forward counts the FLOPs."""
        device = self._device()
        x = self._input(batch_size, device)
        flops = estimate_flops(apply_fn, params, state, x)
        for _ in range(self.warmup - 1):
            apply_fn(params, state, x)
        times = sorted(self._times_ms(apply_fn, params, state, x))
        p50 = statistics.median(times)
        mean = statistics.fmean(times)
        name = "cpu" if device.type == "cpu" else torch.cuda.get_device_name(device)
        stats = {
            "device": name,
            "batch_size": batch_size,
            "iters": self.iters,
            "p50_ms": p50,
            "p95_ms": times[min(int(len(times) * 0.95), len(times) - 1)],
            "mean_ms": mean,
            "std_ms": statistics.pstdev(times),
            "min_ms": times[0],
            "max_ms": times[-1],
            "ms_per_image": mean / batch_size,
            "images_per_s_p50": batch_size / (p50 / 1e3),
            "images_per_s": batch_size / (mean / 1e3),
        }
        stats.update(roofline_fields(params, flops, mean, name))
        return stats

    def compare_models(
        self,
        models: Dict[str, tuple],
        batch_sizes: Sequence[int] = (1, 32),
    ) -> Dict[str, Dict[str, object]]:
        """Per model {name: (apply_fn, params, state)}: model size, then
        latency and throughput at each batch size, and the card's memory."""
        device = self._device()
        results: Dict[str, Dict[str, object]] = {}
        for name, (apply_fn, params, state) in models.items():
            size = tree_nbytes(params)
            entry: Dict[str, object] = {"model_size_bytes": size, "model_size_mb": size / (1024 * 1024)}
            for bs in batch_sizes:
                entry[f"bs{bs}"] = self.measure(apply_fn, params, state, bs)
            if device.type == "cuda":
                entry["device_memory"] = device_memory_stats()
            results[name] = entry
        return results


def scaling_efficiency(throughput: Dict[int, float]) -> Dict[int, float]:
    """eff(n) = throughput(n) / (n * throughput(1)), the multi-host metric
    of the JAX package (quantnet/bench/benchmark.py:372-385); {} without a
    one-device figure."""
    base = throughput.get(1)
    if not base:
        return {}
    return {n: tp / (n * base) for n, tp in sorted(throughput.items())}
