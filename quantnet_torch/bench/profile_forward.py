"""Where the time of one dynamic-INT8 SimpleConvNet forward goes, on the card.

    python -m quantnet_torch.bench.profile_forward [--batch 1024]

Traces five forwards after warm-up with torch.profiler (CPU and CUDA
activity) and prints device time by kernel name, the device's busy share of
the traced wall time, and the card's name and power limit. Needs a card.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

ITERS = 5
TOP = 15


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args(argv)

    from quantnet_torch.core.config import resolve_device
    from quantnet_torch.models import convnet
    from quantnet_torch.quantize import dynamic

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    params, state = convnet.init(torch.Generator().manual_seed(0), device=dev)
    q, qs = dynamic.quantize(params, state)
    x = torch.randn((args.batch, 32, 32, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    for _ in range(5):
        convnet.apply(q, qs, x)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            convnet.apply(q, qs, x)
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
    print(f"bs{args.batch}, {ITERS} forwards: wall {wall_ms / ITERS:.4f} ms per forward, "
          f"device busy {busy_ms / ITERS:.4f} ms per forward "
          f"({100 * busy_ms / wall_ms:.1f}% of wall; idle {100 - 100 * busy_ms / wall_ms:.1f}%)")
    if not rows:
        print("the profiler recorded no device time")
        return 1
    for e in rows[: TOP]:
        ms = e.self_device_time_total / 1e3 / ITERS
        print(f"  {ms:9.4f} ms {100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
              f"x{e.count // ITERS:<3d} {e.key[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
