"""Where the time of one forward goes, on the card.

    python -m quantnet_torch.bench.profile_forward [--batch 1024]
    python -m quantnet_torch.bench.profile_forward --model convnet-static [--batch 1024]
    python -m quantnet_torch.bench.profile_forward --model resnet50 [--batch 128]
    python -m quantnet_torch.bench.profile_forward --model mobilenetv2 [--batch 256]
    python -m quantnet_torch.bench.profile_forward --model convnet-static --batch 32 --graph

--model convnet (the default) is the dynamic-INT8 SimpleConvNet at 32x32;
convnet-static its static-INT8 sibling and resnet50 the static-INT8
ResNet-50 at 224x224, as quantnet_torch.entry's static_entry and
resnet_entry build them (fp32 stem, min-max calibration on 32 images);
mobilenetv2 (mobilenetv2-dynamic) the static-INT8 (dynamic-INT8)
MobileNetV2 at 224x224 as mobilenet_entry builds it (int8 stem).

Traces five forwards after warm-up with torch.profiler (CPU and CUDA
activity) and prints the device time of every kernel by name, and the
device's busy and idle shares of the wall time inside that one trace; then,
on its own, the wall time of 100 untraced forwards, and the card's name and
power limit. The tracer stretches the host's side of each forward, so the
idle share is that of the traced run.
With --graph the forward is captured once in a CUDA graph, as the serving
engine captures a bucket (quantnet_torch/serve/server.py), and the trace
holds 100 replays of it. Needs a card.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

ITERS = 5
GRAPH_ITERS = 100
UNTRACED = 100


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="convnet",
                    choices=("convnet", "convnet-static", "resnet50", "mobilenetv2", "mobilenetv2-dynamic"))
    ap.add_argument("--batch", type=int, default=None,
                    help="1024 (convnets), 128 (resnet50) or 256 (mobilenetv2)")
    ap.add_argument("--graph", action="store_true", help="time replays of a captured forward")
    args = ap.parse_args(argv)

    from quantnet_torch.bench.trace import device_rows, trace
    from quantnet_torch.core.config import resolve_device
    from quantnet_torch.entry import entry, mobilenet_entry, resnet_entry, static_entry

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if args.model == "resnet50":
        args.batch = args.batch or 128
        fn, (q, qs, x) = resnet_entry(dev, batch_size=args.batch)
    elif args.model.startswith("mobilenetv2"):
        args.batch = args.batch or 256
        scheme = "dynamic" if args.model.endswith("dynamic") else "static"
        fn, (q, qs, x) = mobilenet_entry(dev, scheme=scheme, batch_size=args.batch)
    elif args.model == "convnet-static":
        args.batch = args.batch or 1024
        fn, (q, qs, x) = static_entry(dev, batch_size=args.batch)
    else:
        args.batch = args.batch or 1024
        fn, (q, qs, x) = entry(dev, batch_size=args.batch)

    def step():
        fn(q, qs, x)

    if args.graph:
        from quantnet_torch.serve.server import BucketGraph

        step = BucketGraph(lambda xin: fn(q, qs, xin), x, torch.cuda.Stream(dev)).replay
    iters = GRAPH_ITERS if args.graph else ITERS
    for _ in range(5):
        step()
    torch.cuda.synchronize()

    def traced():
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # Busy and wall from the same traced run: the device time of its kernels
    # and the host's clock around its forwards and one synchronize.
    wall_ms, prof = trace(traced)
    rows = device_rows(prof)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    # Wall time per forward without the tracer: back-to-back forwards, the
    # host's clock around them and one synchronize. No idle share: the
    # device time is not read without a trace.
    t0 = time.perf_counter()
    for _ in range(UNTRACED):
        step()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / UNTRACED

    print(f"card: {card}")
    what = "graph replays" if args.graph else "forwards"
    print(f"{args.model} bs{args.batch}, {iters} {what} in one trace: wall {wall_ms / iters:.4f} ms "
          f"per forward, device busy {busy_ms / iters:.4f} ms per forward "
          f"({100 * busy_ms / wall_ms:.1f}% of wall; idle {100 - 100 * busy_ms / wall_ms:.1f}%); "
          f"untraced, on its own: wall {untraced_ms:.4f} ms per forward over {UNTRACED}")
    if not rows:
        print("the profiler recorded no device time")
        return 1
    for e in rows:
        ms = e.self_device_time_total / 1e3 / iters
        print(f"  {ms:9.4f} ms {100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
              f"x{e.count // iters:<3d} {e.key[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
