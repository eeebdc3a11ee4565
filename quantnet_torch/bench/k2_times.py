"""K2 (`fused_dynamic_gemm`) on the card, at the convnet's fc1 and fc2.

    python -m quantnet_torch.bench.k2_times [--batch 1024 32]

For each batch size, builds the dynamic-INT8 SimpleConvNet as
`quantnet_torch.entry.entry` does, runs one forward to capture the inputs
that fc1 and fc2 hand to K2, and times K2 at those shapes four ways:

  events   mean ms per call of 50 back-to-back calls between two CUDA
           events (chip_smoke.py's [times] method; a call shorter than the
           host's cost of issuing it reads at the host's rate);
  warm     the kernel's own device time per call (torch.profiler) over the
           same back-to-back calls: L2 holds the operands;
  cold     the same, with 256 MiB written between calls, so that the
           operands come from device memory, as in the forward, where the
           layers before fc1 pass far more than L2's 50 MB;
each on the forward's own inputs ("real") and on random ones of the same
shapes and types ("random": x ~ 2 N(0, 1), the weight and its scale
uniform). Prints the card's name and power limit first. Needs a card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess

import torch

ITERS = 50


def _capture(batch: int, dev):
    """The (x, w, w_scale, bias) of each K2 call of one forward, and fc1's relu."""
    from quantnet_torch.entry import entry
    from quantnet_torch.ops import linear as ops_linear

    fn, args = entry(dev, batch_size=batch)
    calls = []
    inner = ops_linear.fused_dynamic_gemm

    def record(*a, **kw):
        calls.append((tuple(t.clone() for t in a[:4]), kw))
        return inner(*a, **kw)

    ops_linear.fused_dynamic_gemm = record
    try:
        fn(*args)
        torch.cuda.synchronize()
    finally:
        ops_linear.fused_dynamic_gemm = inner
    return calls


def _random_like(x, w, ws, b, g):
    rx = (torch.randn(x.shape, generator=g, device=x.device) * 2.0).to(x.dtype)
    rw = torch.randint(-127, 128, w.shape, generator=g, device=w.device, dtype=torch.int8)
    rws = torch.rand(ws.shape, generator=g, device=ws.device) * 1e-2 + 1e-4
    return rx, rw, rws, b


def _events_ms(call) -> float:
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def _device_ms(call, flush=None):
    """(median, mean) device ms of K2's kernels per call, from the profiler."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(ITERS):
            if flush is not None:
                flush.add_(1)
            call()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "fused_dynamic" in e.name]
    if not times:
        return float("nan"), float("nan")
    per_call = len(times) // ITERS or 1
    sums = [sum(times[i:i + per_call]) / 1e3 for i in range(0, len(times), per_call)]
    return statistics.median(sums), statistics.fmean(sums)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1024, 32])
    args = ap.parse_args(argv)

    from quantnet_torch.core.config import resolve_device
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}")
    flush = torch.empty((64 << 20,), dtype=torch.float32, device=dev)  # 256 MiB
    g = torch.Generator(device=dev).manual_seed(2)
    for batch in args.batch:
        for i, (ops, kw) in enumerate(_capture(batch, dev)):
            x, w = ops[0], ops[1]
            name = f"fc{i + 1} bs{batch} {tuple(x.shape)}x{tuple(w.shape)} {str(x.dtype)[6:]}"
            for kind, operands in (("real", ops), ("random", _random_like(*ops, g))):
                def call(o=operands):
                    return fused_dynamic_gemm(*o, **kw)

                ev = _events_ms(call)
                warm = _device_ms(call)
                cold = _device_ms(call, flush)
                print(f"  {name} {kind:6s}: events {ev:.4f} ms/call; device warm median "
                      f"{warm[0]:.4f} (mean {warm[1]:.4f}), cold median {cold[0]:.4f} "
                      f"(mean {cold[1]:.4f}) ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
