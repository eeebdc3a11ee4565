#!/usr/bin/env python3
"""Drives quantnet_torch's main path on one NVIDIA card and checks its kernels.

    python3 chip_smoke.py

Two paths are driven: the dynamic-INT8 SimpleConvNet at bs1024 (K1 int8_gemm
through im2col with the bf16 handoff fused into its store, K2
fused_dynamic_gemm with fc1's relu fused into its store) and the static-INT8
ResNet-50 at bs128, 224x224 (K1 at 52 convs and the fc, storing int8 or f32,
K3 residual_boundary at 15 block boundaries). Phases, each printing one line with its wall time:
  1. device     the card's name and power limit (nvidia-smi); no card -> exit 1
  2. build      nvcc builds every kernel (quantnet_torch/_build.py), in
                parallel; ptxas's registers, spills and static shared memory
                of each kernel (K1: per template variant)
  3. int8_gemm  K1's int32 store (the TPU kernel's function) against its plain
                version, exact, at the reference test shapes, the six conv GEMM
                shapes of the convnet at bs1024 and every distinct GEMM shape of
                ResNet-50 at bs128
  4. k1 stores  one forward of each model with every K1 launch held against
                int8_gemm_epilogue_plain on the same inputs, bit for bit: each
                store (bf16, int8, f32) at every shape of both paths
  5. fused      K2 bit-equal to its plain version at fc1 and fc2, at bs1024 and
                bs32, f32 and bf16 x, relu on and off, on random x and on x
                at the quantize's rounding ties, its 1e-8 floor, subnormals
                and past its fast division's range (fused_dynamic_cases)
  6. boundary   K3 against its plain version, bit-equal, both variants, at the
                JAX test shapes, an off-vector shape and ResNet-50's four
                boundary shapes at bs128
  7. times      each kernel at its main-path shapes (CUDA events around
                back-to-back calls), summed over one forward, beside its bound,
                its plain version and, where one PyTorch call computes the
                same, that call; K1 twice: its int32 store beside
                torch._int_mm, and as each path launches it beside the unfused
                route it replaced (the int32 store, then the epilogue in
                PyTorch ops); K2 at bs1024 and bs32, on random inputs and on
                the forward's own fc1 / fc2 inputs; and the host's cost of
                one K1 and one K2 launch beside one torch._int_mm call
  8. convnet    init -> BN fold -> dynamic INT8 -> forward at bs1024; launch
                counts, agreement with the plain versions and fp32, throughput
  9. resnet50   init -> BN fold -> min-max calibration (32 images) -> static
                INT8 bake (fp32 stem) -> forward at bs128; launch counts,
                agreement with the plain versions and fp32, throughput
 10. kernels    one JSON line with an entry per kernel and path it runs on
                (K1 twice: the convnet's and ResNet-50's), each with its numbers
Any failed check raises before the last line, which is the only place that
prints {"ok": true, ...}. Nothing is written outside build/ (gitignored).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

T0 = time.perf_counter()
BATCH = 1024
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and int8 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
# M x K x N of each conv GEMM at bs1024 (im2col: M = N*H*W, K = 9*C_in).
CONV_SHAPES = [
    ("conv1", 1048576, 27, 64),
    ("conv2", 1048576, 576, 64),
    ("conv3", 262144, 576, 128),
    ("conv4", 262144, 1152, 128),
    ("conv5", 65536, 1152, 256),
    ("conv6", 65536, 2304, 256),
]
# fc1 takes conv6's bf16 handoff on the main path, fc2 fc1's f32 output; at
# the bench's batch and at the serving batch of entry().
FC_BATCHES = (1024, 32)
FC_SHAPES = [(name, m, k, n, dtype) for m in FC_BATCHES for name, k, n, dtype in
             (("fc1", 4096, 512, "bfloat16"), ("fc2", 512, 10, "float32"))]
RESNET_BATCH = 128
RESNET_IMAGE = 224
RESNET_CALIBRATION = 32
# K3 shapes beyond ResNet-50's: the JAX package's test shapes
# (tests/test_pallas_kernels.py:117-136) and one that is off the 16-element
# vector step (C = 3, odd M).
BOUNDARY_EXTRA = [("jax_i8", (2, 9, 9, 256), True), ("jax_f32", (4, 7, 7, 512), False),
                  ("odd_i8", (1, 7, 9, 3), True), ("odd_f32", (1, 7, 9, 3), False)]
REFERENCE_SHAPES = [("ref_48x200x136", 48, 200, 136), ("ref_7x33x5", 7, 33, 5)]
# (scale, zero point) domains for the int8 store's division check: ResNet-like
# scales, the EPS floor, a large scale and one outside the fast division's range.
REQUANTIZE_DOMAINS = [(0.061, -128), (0.0123, -7), (1e-8, 0), (7.0, 127), (2.0**-70, 3)]
# Dynamic INT8 against the fp32 model it came from, relative L2 of the logits:
# a sanity bound on the quantization error of eight layers (about 0.03 at
# this seed's random weights and inputs in a CPU rehearsal at bs16).
FP32_REL_L2_MAX = 0.1
# Static INT8 ResNet-50 against its fp32 folded model, relative L2 of the
# logits: min-max calibration on one random batch over 53 quantized layers.
# A CPU rehearsal of this very configuration (seed 0 weights, 32 calibration
# images, bs16 at 224x224) measured 0.0176; the bound leaves about 3x.
RESNET_FP32_REL_L2_MAX = 0.05


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over `iters` back-to-back calls, CUDA events. A call
    whose kernel runs shorter than the host takes to issue it is timed at
    the host's rate."""
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


def host_us(fn, iters: int = 200) -> float:
    """Wall microseconds per call of back-to-back calls of `fn` at a shape
    the card finishes faster than the host issues it: the host's cost of
    one call (an upper bound on it)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


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
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    secs = ", ".join(f"{n} {s:.1f} s" for n, s in _build.build_seconds.items())
    phase("build", t0, f"nvcc + ctypes: {secs or 'already built'}")


def resnet_shapes(batch: int, image: int):
    """ResNet-50's int8 GEMMs and block boundaries at (batch, image): a Counter
    of (M, K, N) over the 52 int8 convs (im2col: M = N*Ho*Wo, K = kh*kw*Cin;
    the stem runs in fp32) and the fc, and one of ((N, H, W, C), int8
    identity) over the 15 boundaries."""
    from collections import Counter

    from quantnet_torch.models.resnet import EXPANSION, STAGE_WIDTHS, VARIANTS

    gemms, boundaries = Counter(), Counter()
    _, stages = VARIANTS[50]
    h = -(-image // 2)  # stem 7x7/2, SAME
    h = (h + 2 - 3) // 2 + 1  # maxpool 3x3/2, pad 1
    cin = 64
    for si, (blocks, width) in enumerate(zip(stages, STAGE_WIDTHS)):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            ho, cout = -(-h // stride), width * EXPANSION
            gemms[(batch * h * h, cin, width)] += 1
            gemms[(batch * ho * ho, 9 * width, width)] += 1
            gemms[(batch * ho * ho, width, cout)] += 1
            downsample = bi == 0 and (stride != 1 or cin != cout)
            if downsample:
                gemms[(batch * ho * ho, cin, cout)] += 1
            if not (si == len(stages) - 1 and bi == blocks - 1):
                boundaries[((batch, ho, ho, cout), not downsample)] += 1
            h, cin = ho, cout
    gemms[(batch, cin, 1000)] += 1
    return gemms, boundaries


def int8_gemm_phase(torch, dev):
    from quantnet_torch.ops.int8_matmul import int8_gemm, int8_gemm_plain

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    gemms, _ = resnet_shapes(RESNET_BATCH, RESNET_IMAGE)
    shapes = [("convnet",) + s for s in REFERENCE_SHAPES + CONV_SHAPES] + [
        ("resnet50", f"resnet50_{m}x{k}x{n}", m, k, n) for m, k, n in sorted(gemms)
    ]
    err = {"convnet": 0.0, "resnet50": 0.0}
    for path, name, m, k, n in shapes:
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        got = int8_gemm(a, b)
        torch.cuda.synchronize()
        ref = int8_gemm_plain(a, b)
        bad = (got != ref).sum().item()
        err[path] = max(err[path], float((got.long() - ref.long()).abs().max().item()))
        if bad:
            idx = (got != ref).nonzero()[0].tolist()
            raise SmokeFailure(
                f"int8_gemm {name} ({m}x{k}x{n}): {bad} of {ref.numel()} differ; first at "
                f"{idx}: {got[idx[0], idx[1]].item()} vs {ref[idx[0], idx[1]].item()}"
            )
        del a, b, got, ref
    # The int8 store's division, alone, on inputs a GEMM seldom makes.
    from quantnet_torch.core.quantize import quantize_affine
    from quantnet_torch.core.types import ActQuant
    from quantnet_torch.ops.int8_matmul import requantize, requantize_cases

    n_div = 0
    for scale, zp in REQUANTIZE_DOMAINS:
        y = requantize_cases(scale, dev)
        aq = ActQuant(torch.tensor(scale, device=dev), torch.tensor(zp, dtype=torch.int32, device=dev))
        bad = int((requantize(y, aq) != quantize_affine(y, aq.scale, aq.zero_point)).sum())
        check(bad == 0, f"int8 requantize, scale {scale}: {bad} of {y.numel()} differ from quantize_affine")
        n_div += y.numel()
    phase("int8_gemm", t0, f"int32 store exact against int8_gemm_plain at {len(shapes)} shapes "
          f"({len(gemms)} of them ResNet-50's at bs{RESNET_BATCH}); the int8 store's division "
          f"bit-equal to quantize_affine on {n_div} inputs in {len(REQUANTIZE_DOMAINS)} domains")
    return err


def boundary_inputs(torch, dev, shape, int8_id, g):
    """f32 out, int8 or f32 identity, and the two domains, like a boundary's."""
    from quantnet_torch.core.types import ActQuant

    out = torch.randn(shape, generator=g, device=dev) * 3.0
    if int8_id:
        ident = torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)
    else:
        ident = torch.randn(shape, generator=g, device=dev)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    id_q = ActQuant(f32(0.043), i32(-5)) if int8_id else None
    return out, ident, id_q, ActQuant(f32(0.061), i32(-128))


def boundary_phase(torch, dev):
    from quantnet_torch.ops.residual_boundary import residual_boundary, residual_boundary_plain

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    _, boundaries = resnet_shapes(RESNET_BATCH, RESNET_IMAGE)
    cases = BOUNDARY_EXTRA + [
        (f"resnet50_{'x'.join(map(str, shape))}_{'i8' if i8 else 'f32'}", shape, i8)
        for shape, i8 in sorted(boundaries)
    ]
    err = 0
    for name, shape, i8 in cases:
        args = boundary_inputs(torch, dev, shape, i8, g)
        got = residual_boundary(*args)
        torch.cuda.synchronize()
        ref = residual_boundary_plain(*args)
        check(got.dtype == torch.int8 and got.shape == ref.shape, f"boundary {name}: {got.dtype}")
        bad = (got != ref).sum().item()
        err = max(err, (got.int() - ref.int()).abs().max().item())
        check(bad == 0, f"residual_boundary {name}: {bad} of {ref.numel()} differ from the plain version")
    phase("boundary", t0, f"bit-equal to residual_boundary_plain at {len(cases)} shapes, "
          "both variants")
    return float(err)


def fused_inputs(torch, dev, m, k, n, g, dtype="float32"):
    x = (torch.randn((m, k), generator=g, device=dev) * 2.0).to(getattr(torch, dtype))
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    w_scale = torch.rand((n,), generator=g, device=dev) * 1e-2 + 1e-4
    bias = torch.randn((n,), generator=g, device=dev)
    return x, w, w_scale, bias


def fused_phase(torch, dev):
    """K2 against its plain version, bit for bit (compared as integers, so -0
    against +0 would count)."""
    from quantnet_torch.ops.fused_dynamic_matmul import (
        fused_dynamic_cases,
        fused_dynamic_gemm,
        fused_dynamic_gemm_plain,
    )

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_cases = 0
    for name, m, k, n, _ in FC_SHAPES:
        for dtype in ("float32", "bfloat16"):
            x, w, w_scale, bias = fused_inputs(torch, dev, m, k, n, g, dtype)
            edge = fused_dynamic_cases(m, k, getattr(torch, dtype), dev)
            for xin, kind in ((x, "random"), (edge, "edge cases")):
                for relu in (False, True):
                    got = fused_dynamic_gemm(xin, w, w_scale, bias, relu)
                    torch.cuda.synchronize()
                    ref = fused_dynamic_gemm_plain(xin, w, w_scale, bias, relu)
                    bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
                    check(bool(torch.isfinite(got).all()),
                          f"fused {name} bs{m} {dtype}: non-finite")
                    check(bad == 0, f"fused_dynamic_gemm {name} bs{m} {dtype} {kind} relu={relu}: "
                          f"{bad} of {ref.numel()} differ from the plain version, max |diff| "
                          f"{(got - ref).abs().max().item()!r}")
                    n_cases += 1
    phase("fused", t0, f"bit-equal to fused_dynamic_gemm_plain in {n_cases} cases: fc1 and fc2 "
          f"at bs{' and bs'.join(map(str, FC_BATCHES))}, f32 and bf16 x, relu on and off, "
          "random x and fused_dynamic_cases")
    return 0.0


def _sums():
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0}


def _add(acc, count, ms, plain, nbytes, ops, lib=0.0):
    acc["ms"] += count * ms
    acc["plain_ms"] += count * plain
    acc["bound_ms"] += count * bound(nbytes, ops)[0]
    acc["bytes_ms"] += count * nbytes / HBM_BYTES_PER_S * 1e3
    acc["ops_ms"] += count * ops / INT8_OPS_PER_S * 1e3
    acc["library_ms"] += count * lib


def bound_by(acc) -> str:
    return "bytes" if acc["bytes_ms"] >= acc["ops_ms"] else "operations"


def _time_int8_gemm(torch, dev, g, m, k, n, iters):
    """(kernel, plain, torch._int_mm) ms of one int8 GEMM with the int32 store."""
    from quantnet_torch.ops.int8_matmul import int8_gemm, int8_gemm_plain

    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    ms = time_ms(lambda: int8_gemm(a, b), iters)
    plain = time_ms(lambda: int8_gemm_plain(a, b), max(iters // 4, 3))
    # torch._int_mm wants M > 16 and K, N % 8 == 0: zero-padding N leaves the
    # product unchanged (K is padded to 16 already; the fc's N = 1000 and
    # M = 128 rows need nothing). A yardstick only.
    np_ = -(-n // 8) * 8
    bp = torch.nn.functional.pad(b, (0, 0, 0, np_ - n)).t()
    lib = time_ms(lambda: torch._int_mm(a, bp), iters)
    return ms, plain, lib


def _time_k1_fused(torch, a, b, epi, iters):
    """(kernel, unfused route, plain) ms of one K1 launch as a path makes it:
    the fused store; the int32 store followed by the epilogue in PyTorch ops
    (what the ops layer ran before); the plain version."""
    from quantnet_torch.ops.int8_matmul import (
        apply_epilogue,
        int8_gemm,
        int8_gemm_epilogue,
        int8_gemm_epilogue_plain,
    )

    ms = time_ms(lambda: int8_gemm_epilogue(a, b, epi), iters)
    unfused = time_ms(lambda: apply_epilogue(int8_gemm(a, b), epi), iters)
    plain = time_ms(lambda: int8_gemm_epilogue_plain(a, b, epi), max(iters // 4, 3))
    return ms, unfused, plain


def _k1_fused_bytes(a, b, epi) -> int:
    """A and B read once, the per-column (and per-row) vectors read once,
    the output written once in its own type."""
    m, n = a.shape[0], b.shape[0]
    vectors = sum(t.numel() * t.element_size() for t in (epi.cs, epi.bias, epi.zpw, epi.rs)
                  if t is not None)
    return a.numel() + b.numel() + vectors + m * n * epi.out.itemsize


def k2_operands(torch, m):
    """{batch: {"fc1": args, "fc2": args}}: the operands of each K2 call of a
    convnet forward at each of FC_BATCHES (its first rows of the bs1024
    images), as the fused branch of ops/linear.py passes them."""
    from quantnet_torch.ops import linear as ops_linear

    inner = ops_linear.fused_dynamic_gemm
    found = {}
    calls = []

    def record(*args):
        calls.append(tuple(t.clone() if hasattr(t, "clone") else t for t in args))
        return inner(*args)

    ops_linear.fused_dynamic_gemm = record
    try:
        for batch in FC_BATCHES:
            calls.clear()
            m["apply"](m["q"], m["qs"], m["x"][:batch])
            found[batch] = dict(zip(("fc1", "fc2"), calls))
    finally:
        ops_linear.fused_dynamic_gemm = inner
    torch.cuda.synchronize()
    return found


def times_phase(torch, dev, k1_calls, models):
    """Per-shape times; returns the per-forward sums of each kernel: K1 on
    the convnet and on ResNet-50 (its int32 store, and as the path launches
    it), K2 on the convnet at each of FC_BATCHES (and its ms on the forward's
    own inputs, and its host cost), K3 on ResNet-50."""
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm, fused_dynamic_gemm_plain
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.ops.residual_boundary import residual_boundary, residual_boundary_plain

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    k1_int32 = {"convnet": _sums(), "resnet50": _sums()}
    k1 = {"convnet": _sums(), "resnet50": _sums()}
    k2 = {batch: _sums() for batch in FC_BATCHES}
    k2_own = {batch: 0.0 for batch in FC_BATCHES}
    k3 = _sums()
    gemms, boundaries = resnet_shapes(RESNET_BATCH, RESNET_IMAGE)
    # The int32 store at the K the kernel runs (conv1's 27 padded to 32;
    # the padded bytes count in the bound).
    int32_shapes = [("convnet", 1, m, -(-k // 16) * 16, n, 30) for _, m, k, n in CONV_SHAPES] + [
        ("resnet50", count, m, k, n, 30) for (m, k, n), count in sorted(gemms.items())]
    for path, count, m, k, n, iters in int32_shapes:
        ms, plain, lib = _time_int8_gemm(torch, dev, g, m, k, n, iters)
        nbytes, ops = m * k + k * n + 4 * m * n, 2 * m * n * k
        print(f"  int8_gemm {path} int32 {m}x{k}x{n} x{count}: kernel {ms:.4f} ms, bound "
              f"{bound(nbytes, ops)[0]:.4f} ms ({bound(nbytes, ops)[1]}), plain {plain:.4f} ms, "
              f"torch._int_mm {lib:.4f} ms")
        _add(k1_int32[path], count, ms, plain, nbytes, ops, lib)
    a = torch.randint(-127, 128, (128, 64), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (64, 64), generator=g, device=dev, dtype=torch.int8)
    small = fused_inputs(torch, dev, 64, 512, 10, g)
    host = {"int8_gemm": host_us(lambda: int8_gemm(a, b)),
            "torch._int_mm": host_us(lambda: torch._int_mm(a, b.t())),
            "fused_dynamic_gemm": host_us(lambda: fused_dynamic_gemm(*small))}
    print(f"  host cost of one call: int8_gemm {host['int8_gemm']:.2f} us and torch._int_mm "
          f"{host['torch._int_mm']:.2f} us at 128x64x64, fused_dynamic_gemm "
          f"{host['fused_dynamic_gemm']:.2f} us at 64x512x10")
    for path, calls in k1_calls.items():
        for (m, k, n, store), (count, a, b, epi) in sorted(calls.items()):
            ms, unfused, plain = _time_k1_fused(torch, a, b, epi, 20)
            nbytes, ops = _k1_fused_bytes(a, b, epi), 2 * m * n * k
            print(f"  int8_gemm {path} {store} {m}x{k}x{n} x{count}: kernel {ms:.4f} ms, bound "
                  f"{bound(nbytes, ops)[0]:.4f} ms ({bound(nbytes, ops)[1]}), unfused route "
                  f"{unfused:.4f} ms, plain {plain:.4f} ms")
            _add(k1[path], count, ms, plain, nbytes, ops, unfused)
    own = k2_operands(torch, models["convnet"])
    for name, m, k, n, dtype in FC_SHAPES:
        args = fused_inputs(torch, dev, m, k, n, g, dtype) + (name == "fc1",)  # fc1's relu
        ms = time_ms(lambda: fused_dynamic_gemm(*args))
        plain = time_ms(lambda: fused_dynamic_gemm_plain(*args))
        own_args = own[m][name]
        check(tuple(own_args[0].shape) == (m, k) and own_args[0].dtype == args[0].dtype,
              f"{name} bs{m} takes {tuple(own_args[0].shape)} {own_args[0].dtype} in the forward")
        own_ms = time_ms(lambda: fused_dynamic_gemm(*own_args))
        nbytes = args[0].element_size() * m * k + k * n + 8 * n + 4 * m * n
        ops = 2 * m * n * k
        print(f"  fused_dynamic_gemm {name} {m}x{k}x{n} {dtype} x: kernel {ms:.4f} ms (on the "
              f"forward's own input {own_ms:.4f} ms), bound {bound(nbytes, ops)[0]:.4f} ms "
              f"({bound(nbytes, ops)[1]}), plain {plain:.4f} ms")
        _add(k2[m], 1, ms, plain, nbytes, ops)
        k2_own[m] += own_ms
    for (shape, i8), count in sorted(boundaries.items()):
        args = boundary_inputs(torch, dev, shape, i8, g)
        ms = time_ms(lambda: residual_boundary(*args))
        plain = time_ms(lambda: residual_boundary_plain(*args))
        elems = math.prod(shape)
        # f32 out read, identity read (1 or 4 bytes), int8 q written; about
        # 8 flops per element (dequantize 2, add, relu, divide, round, add, clamp).
        nbytes, ops = elems * (6 if i8 else 9), 8 * elems
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"  residual_boundary {'x'.join(map(str, shape))} {'int8' if i8 else 'f32'} identity "
              f"x{count}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms (bytes), plain {plain:.4f} ms")
        _add(k3, count, ms, plain, nbytes, 0)
        k3["ops_ms"] += count * ops / F32_OPS_PER_S * 1e3
    per_path = "; ".join(
        f"int8_gemm {p} int32 {k1_int32[p]['ms']:.4f} ms (bound {k1_int32[p]['bound_ms']:.4f}, "
        f"torch._int_mm {k1_int32[p]['library_ms']:.4f}), as launched {k1[p]['ms']:.4f} ms (bound "
        f"{k1[p]['bound_ms']:.4f}, unfused route {k1[p]['library_ms']:.4f})" for p in k1)
    per_batch = "; ".join(
        f"fused_dynamic_gemm bs{bt} {k2[bt]['ms']:.4f} ms (own inputs {k2_own[bt]:.4f}, bound "
        f"{k2[bt]['bound_ms']:.4f}, plain {k2[bt]['plain_ms']:.4f})" for bt in FC_BATCHES)
    phase("times", t0, f"per forward: {per_path}; {per_batch}; residual_boundary "
          f"{k3['ms']:.4f} ms (bound {k3['bound_ms']:.4f}, plain {k3['plain_ms']:.4f}); host "
          f"cost per call int8_gemm {host['int8_gemm']:.2f} us, fused_dynamic_gemm "
          f"{host['fused_dynamic_gemm']:.2f} us, torch._int_mm {host['torch._int_mm']:.2f} us")
    first = FC_BATCHES[0]
    k2_entry = dict(k2[first], own_ms=k2_own[first], host_us=host["fused_dynamic_gemm"])
    for bt in FC_BATCHES[1:]:
        k2_entry.update({f"bs{bt}_ms": k2[bt]["ms"], f"bs{bt}_own_ms": k2_own[bt],
                         f"bs{bt}_bound_ms": k2[bt]["bound_ms"],
                         f"bs{bt}_plain_ms": k2[bt]["plain_ms"]})
    return k1_int32, k1, k2_entry, k3


def build_models(torch, dev):
    """Both paths' models as a user builds them, from seeds: the dynamic-INT8
    convnet (init -> BN fold -> dynamic quantize) with a bs1024 batch, and the
    static-INT8 ResNet-50 (init -> BN fold -> min-max calibration on 32
    images -> bake, fp32 stem) with a bs128 batch at 224x224."""
    from quantnet_torch.models import convnet, resnet
    from quantnet_torch.quantize import dynamic, static

    t0 = time.perf_counter()
    params, state = convnet.init(torch.Generator().manual_seed(SEED), device=dev)
    qparams, qstate = dynamic.quantize(params, state)
    x = torch.randn((BATCH, 32, 32, 3), generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    models = {"convnet": dict(apply=convnet.apply, params=params, state=state, q=qparams,
                              qs=qstate, x=x)}
    t1 = time.perf_counter()
    params, state = resnet.init(torch.Generator().manual_seed(SEED), depth=50, device=dev)
    shape = (RESNET_CALIBRATION, RESNET_IMAGE, RESNET_IMAGE, 3)
    calib = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    qparams, qstate = static.quantize(params, state, resnet.apply, [calib], skip_first_layer=True)
    shape = (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 2)).to(dev)
    torch.cuda.synchronize()
    models["resnet50"] = dict(apply=resnet.apply, params=params, state=state, q=qparams,
                              qs=qstate, x=x, set_up_s=time.perf_counter() - t1)
    phase("models", t0, f"convnet bs{BATCH}, resnet50 bs{RESNET_BATCH} {RESNET_IMAGE}x"
          f"{RESNET_IMAGE} (set-up {models['resnet50']['set_up_s']:.2f} s)")
    return models


def _store_name(epi) -> str:
    parts = [str(epi.out).rsplit(".", 1)[-1]]
    parts += [n for n in ("zpw", "rs", "bias") if getattr(epi, n) is not None]
    return " ".join(parts + (["relu"] if epi.relu else []))


def k1_stores_phase(torch, models):
    """One forward of each model with every K1 launch held against
    int8_gemm_epilogue_plain on the same inputs, bit for bit (compared as
    integers, so -0 against +0 would count). Returns, per path, the calls by
    (M, K, N, store) with their count and one call's inputs, for [times]."""
    from quantnet_torch.ops import linear as ops_linear
    from quantnet_torch.ops.int8_matmul import int8_gemm_epilogue, int8_gemm_epilogue_plain

    t0 = time.perf_counter()
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.int8: torch.int8}
    calls = {}

    def checked(a, b, epi):
        got = int8_gemm_epilogue(a, b, epi)
        ref = int8_gemm_epilogue_plain(a, b, epi)
        key = (a.shape[0], a.shape[1], b.shape[0], _store_name(epi))
        bad = int((got.contiguous().view(bits[epi.out]) != ref.view(bits[epi.out])).sum())
        check(got.dtype == ref.dtype and bad == 0,
              f"int8_gemm_epilogue {key}: {bad} of {ref.numel()} differ from the plain version")
        calls.setdefault(key, [0, a, b, epi])[0] += 1
        return got

    found = {}
    ops_linear.int8_gemm_epilogue = checked
    try:
        for path, m in models.items():
            calls = {}
            m["apply"](m["q"], m["qs"], m["x"])
            torch.cuda.synchronize()
            found[path] = calls
    finally:
        ops_linear.int8_gemm_epilogue = int8_gemm_epilogue
    n = {p: sum(c[0] for c in v.values()) for p, v in found.items()}
    kinds = {p: sorted({k[3] for k in v}) for p, v in found.items()}
    phase("k1 stores", t0, f"every K1 launch of a forward bit-equal to int8_gemm_epilogue_plain: "
          f"convnet {n['convnet']} launches at {len(found['convnet'])} shapes ({', '.join(kinds['convnet'])}), "
          f"resnet50 {n['resnet50']} at {len(found['resnet50'])} ({', '.join(kinds['resnet50'])})")
    return found


def main_path_phase(torch, dev, m):
    from quantnet_torch.bench.benchmark import InferenceBenchmark
    from quantnet_torch.core.config import Flags
    from quantnet_torch.models import convnet
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.quantize import fold

    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 reference below
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    params, state, qparams, qstate, x = m["params"], m["state"], m["q"], m["qs"], m["x"]
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
    # Every kernel on this path is bit-exact against its plain version.
    check(torch.equal(logits.view(torch.int32), ref.view(torch.int32)),
          f"main path vs plain versions: max |diff| {err} (max|logit| {scale}), not bit-equal")
    # The serving batch launches the same kernels (fc1 on 8 SMs, not 128).
    int8_gemm.launches = fused_dynamic_gemm.launches = 0
    convnet.apply(qparams, qstate, x[:32])
    torch.cuda.synchronize()
    small = {"int8_gemm": int8_gemm.launches, "fused_dynamic_gemm": fused_dynamic_gemm.launches}
    check(small == launches, f"launches per forward at bs32 {small}, at bs{BATCH} {launches}")
    fparams, fstate = fold.fold_model(params, state)
    fp32, _ = convnet.apply(fparams, fstate, x)
    rel = ((logits - fp32).norm() / fp32.norm()).item()
    agree = (logits.argmax(1) == fp32.argmax(1)).float().mean().item()
    check(rel < FP32_REL_L2_MAX, f"dynamic INT8 vs fp32 logits: relative L2 {rel} >= {FP32_REL_L2_MAX}")
    phase("main path", t0, f"logits {tuple(logits.shape)} finite; launches {launches} (bs32 "
          f"too); max |kernels - plain| {err!r} (max|logit| {scale:.4f}, bit-equal); vs fp32: rel "
          f"L2 {rel:.4f}, "
          f"top-1 agreement {agree:.4f}; peak {peak_gib:.2f} GiB")

    t1 = time.perf_counter()
    stats = InferenceBenchmark(warmup=10, iters=50).measure(convnet.apply, qparams, qstate, BATCH)
    phase("bench", t1, f"bs{BATCH}: p50 {stats['p50_ms']:.4f} ms, {stats['images_per_s_p50']:.1f} img/s "
          f"(mean {stats['mean_ms']:.4f} ms, min {stats['min_ms']:.4f}, max {stats['max_ms']:.4f}, "
          f"{stats['iters']} iters) on {stats['device']}")
    return launches


def resnet_phase(torch, dev, m):
    """The static-INT8 ResNet-50 path at bs128, 224x224, as a user builds it."""
    from quantnet_torch.bench.benchmark import InferenceBenchmark
    from quantnet_torch.core.config import Flags
    from quantnet_torch.models import resnet
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.ops.residual_boundary import residual_boundary
    from quantnet_torch.quantize import fold

    t0 = time.perf_counter()
    params, state, qparams, qstate, x = m["params"], m["state"], m["q"], m["qs"], m["x"]
    set_up_s = m["set_up_s"]
    torch.cuda.reset_peak_memory_stats()

    int8_gemm.launches = residual_boundary.launches = fused_dynamic_gemm.launches = 0
    logits, _ = resnet.apply(qparams, qstate, x)
    torch.cuda.synchronize()
    launches = {"int8_gemm": int8_gemm.launches, "residual_boundary": residual_boundary.launches,
                "fused_dynamic_gemm": fused_dynamic_gemm.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    check(tuple(logits.shape) == (RESNET_BATCH, 1000), f"logits shape {tuple(logits.shape)}")
    check(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(launches == {"int8_gemm": 53, "residual_boundary": 15, "fused_dynamic_gemm": 0},
          f"launches per forward {launches}, expected 53 int8_gemm and 15 residual_boundary")

    ref, _ = resnet.apply(qparams, qstate, x, flags=Flags(plain=True))
    scale = ref.abs().max().item()
    err = (logits - ref).abs().max().item()
    # Every kernel on this path is bit-exact against its plain version.
    check(torch.equal(logits, ref),
          f"resnet50 vs plain versions: max |diff| {err} (max|logit| {scale}), not bit-equal")
    fparams, fstate = fold.fold_model(params, state)
    fp32, _ = resnet.apply(fparams, fstate, x)
    rel = ((logits - fp32).norm() / fp32.norm()).item()
    agree = (logits.argmax(1) == fp32.argmax(1)).float().mean().item()
    check(rel < RESNET_FP32_REL_L2_MAX,
          f"static INT8 vs fp32 logits: relative L2 {rel} >= {RESNET_FP32_REL_L2_MAX}")
    phase("resnet50", t0, f"set-up {set_up_s:.2f} s; logits {tuple(logits.shape)} finite; "
          f"launches {launches}; max |kernels - plain| {err!r} (max|logit| {scale:.4f}"
          f"{', bit-equal' if err == 0 else ''}); vs fp32: rel L2 {rel:.4f}, top-1 agreement "
          f"{agree:.4f}; peak {peak_gib:.2f} GiB")

    t1 = time.perf_counter()
    bench = InferenceBenchmark(image_size=RESNET_IMAGE, warmup=5, iters=30)
    stats = bench.measure(resnet.apply, qparams, qstate, RESNET_BATCH)
    phase("resnet50 bench", t1, f"bs{RESNET_BATCH} {RESNET_IMAGE}x{RESNET_IMAGE}: p50 "
          f"{stats['p50_ms']:.4f} ms, {stats['images_per_s_p50']:.1f} img/s (mean "
          f"{stats['mean_ms']:.4f} ms, min {stats['min_ms']:.4f}, max {stats['max_ms']:.4f}, "
          f"{stats['iters']} iters) on {stats['device']}")
    return launches


def main() -> int:
    import torch

    name, _ = device_phase(torch)
    dev = torch.device("cuda", 0)
    build_phase()
    int8_err = int8_gemm_phase(torch, dev)
    models = build_models(torch, dev)
    k1_calls = k1_stores_phase(torch, models)
    fused_err = fused_phase(torch, dev)
    boundary_err = boundary_phase(torch, dev)
    k1_int32, k1, k2, k3 = times_phase(torch, dev, k1_calls, models)
    del k1_calls
    convnet_launches = main_path_phase(torch, dev, models["convnet"])
    resnet_launches = resnet_phase(torch, dev, models["resnet50"])

    def entry(kname, path, source, replaces, launches, err, sums, library):
        return {
            "name": kname, "path": path, "route": "cuda",
            "source": f"quantnet_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            "ms": sums["ms"], "plain_ms": sums["plain_ms"], "bound_ms": sums["bound_ms"],
            "bound_by": bound_by(sums), "library_ms": library,
        }

    def k1_entry(path, launches):
        """K1 as the path launches it (its fused stores: ms, bound, plain),
        with its int32 store beside torch._int_mm and the unfused route it
        replaced. No single PyTorch call computes GEMM and epilogue together,
        so library_ms is null; torch._int_mm times the int32 store."""
        e = entry("int8_gemm", path, "int8_gemm.cu", "quantnet/ops/pallas_matmul.py:54", launches,
                  int8_err[path], k1[path], None)
        e.update(unfused_ms=k1[path]["library_ms"], int32_ms=k1_int32[path]["ms"],
                 int32_bound_ms=k1_int32[path]["bound_ms"],
                 int32_library_ms=k1_int32[path]["library_ms"])
        return e

    def k2_entry(launches):
        """K2 at bs1024 (ms, bound, plain over one forward's fc1 and fc2, on
        random inputs); beside it the same on the forward's own inputs, the
        bs32 figures and the host's cost of one call."""
        e = entry("fused_dynamic_gemm", "convnet", "fused_dynamic_gemm.cu",
                  "quantnet/ops/pallas_matmul.py:143", launches, fused_err, k2, None)
        e.update({key: v for key, v in k2.items() if key not in _sums()})
        return e

    # One entry per (kernel, path): K1 runs on both paths, at other shapes,
    # so each path's launches, times and bound stay comparable across runs.
    kernels = [
        k1_entry("convnet", convnet_launches["int8_gemm"]),
        k1_entry("resnet50", resnet_launches["int8_gemm"]),
        k2_entry(convnet_launches["fused_dynamic_gemm"]),
        entry("residual_boundary", "resnet50", "residual_boundary.cu",
              "quantnet/ops/pallas_boundary.py:85", resnet_launches["residual_boundary"],
              boundary_err, k3, None),
    ]
    print(f"kernels: int8_gemm exact (int32) and bit-equal (every store) on both paths; "
          f"fused_dynamic_gemm and residual_boundary bit-equal; no "
          "PyTorch call computes K1's fused store, K2 or K3 alone (library: none; "
          "int32_library_ms is torch._int_mm against K1's int32 store)")
    print(f"total {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
