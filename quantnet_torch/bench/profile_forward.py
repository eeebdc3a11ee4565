"""Where the time of one forward goes, on the card.

    python -m quantnet_torch.bench.profile_forward [--batch 1024]
    python -m quantnet_torch.bench.profile_forward --model convnet-static [--batch 1024]
    python -m quantnet_torch.bench.profile_forward --model resnet50 [--batch 128]

--model convnet (the default) is the dynamic-INT8 SimpleConvNet at 32x32;
convnet-static its static-INT8 sibling and resnet50 the static-INT8
ResNet-50 at 224x224, as quantnet_torch.entry's static_entry and
resnet_entry build them (fp32 stem, min-max calibration on 32 images).

Traces five forwards after warm-up with torch.profiler (CPU and CUDA
activity) and prints the device time of every kernel by name, the device's
busy share of the traced wall time, and the card's name and power limit.
Needs a card.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

ITERS = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("convnet", "convnet-static", "resnet50"), default="convnet")
    ap.add_argument("--batch", type=int, default=None, help="1024 (convnets) or 128 (resnet50)")
    args = ap.parse_args(argv)

    from quantnet_torch.core.config import resolve_device
    from quantnet_torch.entry import entry, resnet_entry, static_entry

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if args.model == "resnet50":
        args.batch = args.batch or 128
        fn, (q, qs, x) = resnet_entry(dev, batch_size=args.batch)
    elif args.model == "convnet-static":
        args.batch = args.batch or 1024
        fn, (q, qs, x) = static_entry(dev, batch_size=args.batch)
    else:
        args.batch = args.batch or 1024
        fn, (q, qs, x) = entry(dev, batch_size=args.batch)
    for _ in range(5):
        fn(q, qs, x)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn(q, qs, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # Device kernels only: their self device time, summed by kernel name.
    rows = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"card: {card}")
    print(f"{args.model} bs{args.batch}, {ITERS} forwards: wall {wall_ms / ITERS:.4f} ms per forward, "
          f"device busy {busy_ms / ITERS:.4f} ms per forward "
          f"({100 * busy_ms / wall_ms:.1f}% of wall; idle {100 - 100 * busy_ms / wall_ms:.1f}%)")
    if not rows:
        print("the profiler recorded no device time")
        return 1
    for e in rows:
        ms = e.self_device_time_total / 1e3 / ITERS
        print(f"  {ms:9.4f} ms {100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
              f"x{e.count // ITERS:<3d} {e.key[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
