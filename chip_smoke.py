#!/usr/bin/env python3
"""Drives quantnet_torch's main path on one NVIDIA card and checks its kernels.

    python3 chip_smoke.py

Phases, each printing one line with its wall time:
  1. device     the card's name and power limit (nvidia-smi); no card -> exit 1
  2. build      nvcc builds every kernel of the path (quantnet_torch/_build.py)
  3. int8_gemm  the kernel against its plain version, exact, at the reference
                test shapes and the six conv GEMM shapes at bs1024
  4. fused      the fused dynamic-quant GEMM against its plain version at fc1
                and fc2, within float-order tolerance
  5. times      each kernel at its main-path shapes (CUDA events, >= 20
                launches after warm-up) beside its bound, its plain version and,
                where one PyTorch call computes the same, that call
  6. main path  init -> BN fold -> dynamic INT8 quantize -> forward of the
                full-width SimpleConvNet at bs1024; launch counts, agreement
                with the same model through the plain versions, throughput
  7. kernels    one JSON line of every kernel with its numbers
Any failed check raises before the last line, which is the only place that
prints {"ok": true, ...}. Nothing is written outside build/ (gitignored).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

T0 = time.perf_counter()
BATCH = 1024
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and int8 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# M x K x N of each conv GEMM at bs1024 (im2col: M = N*H*W, K = 9*C_in).
CONV_SHAPES = [
    ("conv1", 1048576, 27, 64),
    ("conv2", 1048576, 576, 64),
    ("conv3", 262144, 576, 128),
    ("conv4", 262144, 1152, 128),
    ("conv5", 65536, 1152, 256),
    ("conv6", 65536, 2304, 256),
]
FC_SHAPES = [("fc1", 1024, 4096, 512), ("fc2", 1024, 512, 10)]
REFERENCE_SHAPES = [("ref_48x200x136", 48, 200, 136), ("ref_7x33x5", 7, 33, 5)]
# Kernel vs plain version, fused GEMM: both do the same f32 steps in the same
# order, so only float order could part them.
FUSED_RTOL, FUSED_ATOL = 1e-5, 1e-4
# Main path vs the same model through the plain versions, relative to max|logit|.
LOGITS_RTOL = 1e-3
# Dynamic INT8 against the fp32 model it came from, relative L2 of the logits:
# a sanity bound on the quantization error of eight layers (about 0.03 at
# this seed's random weights and inputs in a CPU rehearsal at bs16).
FP32_REL_L2_MAX = 0.1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over `iters` back-to-back calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    """(least ms, what bounds it) on the card's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_phase(torch):
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    phase("device", t0, f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} card(s)")
    print(card)
    return name, card


def build_phase():
    from quantnet_torch import _build

    t0 = time.perf_counter()
    libs = _build.build()
    check(set(libs) == set(_build.SIGNATURES), f"built {sorted(libs)}")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}", file=sys.stderr)
    secs = ", ".join(f"{n} {s:.1f} s" for n, s in _build.build_seconds.items())
    phase("build", t0, f"nvcc + ctypes: {secs or 'already built'}")


def int8_gemm_phase(torch, dev):
    from quantnet_torch.ops.int8_matmul import int8_gemm, int8_gemm_plain

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    err = 0
    for name, m, k, n in REFERENCE_SHAPES + CONV_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        got = int8_gemm(a, b)
        torch.cuda.synchronize()
        ref = int8_gemm_plain(a, b)
        bad = (got != ref).sum().item()
        err = max(err, (got.long() - ref.long()).abs().max().item())
        if bad:
            idx = (got != ref).nonzero()[0].tolist()
            raise SmokeFailure(
                f"int8_gemm {name} ({m}x{k}x{n}): {bad} of {ref.numel()} differ; first at "
                f"{idx}: {got[idx[0], idx[1]].item()} vs {ref[idx[0], idx[1]].item()}"
            )
        del a, b, got, ref
    phase("int8_gemm", t0, f"exact against int8_gemm_plain at "
          f"{len(REFERENCE_SHAPES) + len(CONV_SHAPES)} shapes")
    return float(err)


def fused_inputs(torch, dev, m, k, n, g):
    x = torch.randn((m, k), generator=g, device=dev) * 2.0
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    w_scale = torch.rand((n,), generator=g, device=dev) * 1e-2 + 1e-4
    bias = torch.randn((n,), generator=g, device=dev)
    return x, w, w_scale, bias


def fused_phase(torch, dev):
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm, fused_dynamic_gemm_plain

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    err = 0.0
    for name, m, k, n in FC_SHAPES:
        args = fused_inputs(torch, dev, m, k, n, g)
        got = fused_dynamic_gemm(*args)
        torch.cuda.synchronize()
        ref = fused_dynamic_gemm_plain(*args)
        e = (got - ref).abs().max().item()
        err = max(err, e)
        check(bool(torch.isfinite(got).all()), f"fused {name}: non-finite output")
        check(
            torch.allclose(got, ref, rtol=FUSED_RTOL, atol=FUSED_ATOL),
            f"fused_dynamic_gemm {name}: max |kernel - plain| = {e}",
        )
    phase("fused", t0, f"within rtol {FUSED_RTOL}, atol {FUSED_ATOL} of "
          f"fused_dynamic_gemm_plain at fc1, fc2; max abs err {err!r}")
    return err


def times_phase(torch, dev):
    """Per-shape times; returns the per-forward sums of each kernel."""
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm, fused_dynamic_gemm_plain
    from quantnet_torch.ops.int8_matmul import int8_gemm, int8_gemm_plain

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for name, m, k, n in CONV_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        ms = time_ms(lambda: int8_gemm(a, b))
        plain = time_ms(lambda: int8_gemm_plain(a, b))
        b_ms, by = bound(m * k + k * n + 4 * m * n, 2 * m * n * k)
        # torch._int_mm wants K % 8 == 0: conv1's K = 27 is zero-padded to 32,
        # which leaves the product unchanged. A yardstick only.
        kp = -(-k // 8) * 8
        ap = torch.nn.functional.pad(a, (0, kp - k))
        bp = torch.nn.functional.pad(b, (0, kp - k)).t()
        lib = time_ms(lambda: torch._int_mm(ap, bp))
        print(f"  int8_gemm {name} {m}x{k}x{n}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({by}), plain {plain:.4f} ms, torch._int_mm {lib:.4f} ms")
        k1["ms"] += ms
        k1["plain_ms"] += plain
        k1["bound_ms"] += b_ms
        k1["bytes_ms"] += (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S * 1e3
        k1["ops_ms"] += 2 * m * n * k / INT8_OPS_PER_S * 1e3
        k1["library_ms"] += lib
        del a, b, ap, bp
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for name, m, k, n in FC_SHAPES:
        args = fused_inputs(torch, dev, m, k, n, g)
        ms = time_ms(lambda: fused_dynamic_gemm(*args))
        plain = time_ms(lambda: fused_dynamic_gemm_plain(*args))
        nbytes = 4 * m * k + k * n + 8 * n + 4 * m * n
        b_ms, by = bound(nbytes, 2 * m * n * k)
        print(f"  fused_dynamic_gemm {name} {m}x{k}x{n}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({by}), plain {plain:.4f} ms")
        k2["ms"] += ms
        k2["plain_ms"] += plain
        k2["bound_ms"] += b_ms
        k2["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        k2["ops_ms"] += 2 * m * n * k / INT8_OPS_PER_S * 1e3
    phase("times", t0, f"int8_gemm {k1['ms']:.4f} ms per forward (bound {k1['bound_ms']:.4f}); "
          f"fused_dynamic_gemm {k2['ms']:.4f} ms (bound {k2['bound_ms']:.4f})")
    return k1, k2


def main_path_phase(torch, dev):
    from quantnet_torch.bench.benchmark import InferenceBenchmark
    from quantnet_torch.core.config import Flags
    from quantnet_torch.models import convnet
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.quantize import dynamic, fold

    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 reference below
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    params, state = convnet.init(torch.Generator().manual_seed(SEED), device=dev)
    qparams, qstate = dynamic.quantize(params, state)
    x = torch.randn((BATCH, 32, 32, 3), generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    int8_gemm.launches = 0
    fused_dynamic_gemm.launches = 0
    logits, _ = convnet.apply(qparams, qstate, x)
    torch.cuda.synchronize()
    launches = {"int8_gemm": int8_gemm.launches, "fused_dynamic_gemm": fused_dynamic_gemm.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    check(tuple(logits.shape) == (BATCH, 10), f"logits shape {tuple(logits.shape)}")
    check(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(launches == {"int8_gemm": 6, "fused_dynamic_gemm": 2},
          f"launches per forward {launches}, expected 6 int8_gemm and 2 fused_dynamic_gemm")

    ref, _ = convnet.apply(qparams, qstate, x, flags=Flags(plain=True))
    scale = ref.abs().max().item()
    err = (logits - ref).abs().max().item()
    check(err <= LOGITS_RTOL * max(scale, 1.0),
          f"main path vs plain versions: max |diff| {err} > {LOGITS_RTOL} * max|logit| {scale}")
    fparams, fstate = fold.fold_model(params, state)
    fp32, _ = convnet.apply(fparams, fstate, x)
    rel = ((logits - fp32).norm() / fp32.norm()).item()
    agree = (logits.argmax(1) == fp32.argmax(1)).float().mean().item()
    check(rel < FP32_REL_L2_MAX, f"dynamic INT8 vs fp32 logits: relative L2 {rel} >= {FP32_REL_L2_MAX}")
    phase("main path", t0, f"logits {tuple(logits.shape)} finite; launches {launches}; "
          f"max |kernels - plain| {err!r} (max|logit| {scale:.4f}); vs fp32: rel L2 {rel:.4f}, "
          f"top-1 agreement {agree:.4f}; peak {peak_gib:.2f} GiB")

    t1 = time.perf_counter()
    stats = InferenceBenchmark(warmup=10, iters=50).measure(convnet.apply, qparams, qstate, BATCH)
    phase("bench", t1, f"bs{BATCH}: p50 {stats['p50_ms']:.4f} ms, {stats['images_per_s_p50']:.1f} img/s "
          f"(mean {stats['mean_ms']:.4f} ms, min {stats['min_ms']:.4f}, max {stats['max_ms']:.4f}, "
          f"{stats['iters']} iters) on {stats['device']}")
    return launches


def main() -> int:
    import torch

    name, _ = device_phase(torch)
    dev = torch.device("cuda", 0)
    build_phase()
    int8_err = int8_gemm_phase(torch, dev)
    fused_err = fused_phase(torch, dev)
    k1, k2 = times_phase(torch, dev)
    launches = main_path_phase(torch, dev)

    kernels = [
        {
            "name": "int8_gemm", "route": "cuda", "source": "quantnet_torch/csrc/int8_gemm.cu",
            "replaces": "quantnet/ops/pallas_matmul.py:54", "launches": launches["int8_gemm"],
            "max_abs_err": int8_err, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"],
            "bound_by": "bytes" if k1["bytes_ms"] >= k1["ops_ms"] else "operations",
            "library_ms": k1["library_ms"],
        },
        {
            "name": "fused_dynamic_gemm", "route": "cuda",
            "source": "quantnet_torch/csrc/fused_dynamic_gemm.cu",
            "replaces": "quantnet/ops/pallas_matmul.py:143",
            "launches": launches["fused_dynamic_gemm"], "max_abs_err": fused_err,
            "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
            "bound_by": "bytes" if k2["bytes_ms"] >= k2["ops_ms"] else "operations",
            "library_ms": None,
        },
    ]
    print("kernels: int8_gemm exact at 8 shapes, 6 launches per forward; "
          f"fused_dynamic_gemm within tolerance (max abs err {fused_err!r}), 2 launches per "
          "forward; residual_boundary (quantnet/ops/pallas_boundary.py:85) not ported")
    print(f"total {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
