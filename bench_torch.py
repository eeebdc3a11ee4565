#!/usr/bin/env python3
"""Throughput of the port's dynamic-INT8 SimpleConvNet on one NVIDIA card.

    python3 bench_torch.py

The deployment that bench.py measures for the JAX package: SimpleConvNet
from seed 0, BN folded, dynamic INT8 with the bf16 inter-layer handoff,
bs1024, InferenceBenchmark(image_size=32, warmup=10, iters=200). Prints the
roofline fields and the card on one line, then, as its last line, one JSON
line with bench.py's keys under this script's own metric name; vs_baseline
is against the same reference throughput as bench.py's. Needs a card: it
raises without one.
"""
from __future__ import annotations

import json
import sys

BASELINE_IMG_S = 1724.14  # the reference's custom-quant INT8 throughput at bs32 (BASELINE.md)
METRIC = "cifar10_convnet_int8_dynamic_throughput_bs1024_p50_torch"
BATCH = 1024


def main() -> int:
    import torch

    from quantnet_torch.bench.benchmark import InferenceBenchmark
    from quantnet_torch.core.config import resolve_device
    from quantnet_torch.models import convnet
    from quantnet_torch.quantize import dynamic

    device = resolve_device("cuda")
    params, state = convnet.init(torch.Generator().manual_seed(0), device=device)
    qparams, qstate = dynamic.quantize(params, state)
    stats = InferenceBenchmark(image_size=32, warmup=10, iters=200).measure(
        convnet.apply, qparams, qstate, BATCH
    )
    keys = ("device", "p50_ms", "mean_ms", "model_gops", "achieved_tops", "peak_tops", "mfu")
    print(json.dumps({k: stats[k] for k in keys if k in stats}), flush=True)
    value = stats["images_per_s_p50"]
    print(json.dumps({
        "metric": METRIC,
        "value": round(value, 2),
        "unit": "img/s",
        "vs_baseline": round(value / BASELINE_IMG_S, 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
