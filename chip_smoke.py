#!/usr/bin/env python3
"""Drives quantnet_torch's main paths on one NVIDIA card and checks its kernels.

    python3 chip_smoke.py

The paths: the dynamic-INT8 SimpleConvNet at bs1024 (K1 int8_gemm through
im2col with the bf16 handoff fused into its store, K2 fused_dynamic_gemm with
fc1's relu fused into its store), its static-INT8 sibling at bs1024 (fp32
stem, K1 storing int8 in the next layer's domain, f32 at fc2) and its W4A8
bake (fc1 and fc2 through K1's grouped-K mode, g128); the static-INT8
ResNet-50 at bs128, 224x224 (K1 at 52 convs and the fc, K3 residual_boundary
at 15 block boundaries), also with an int8 stem, 7x7 and space-to-depth;
MobileNetV2 1.0 at bs256, 224x224, static (K1 at 36 layers with relu6 in its
stores, K4 depthwise_conv at 17) and dynamic (K2 at the fc). Then the
convnet's scheme matrix and the port's bench script. Phases, each printing
one line with its wall time:
  1. device     the card's name and power limit (nvidia-smi); no card -> exit 1
  2. build      nvcc builds every kernel (quantnet_torch/_build.py), in
                parallel; ptxas's registers, spills and static shared memory
  3. int8_gemm  K1's int32 store exact at the reference test shapes and the
                GEMM shapes of the convnets and ResNet-50; the int8 store's
                division on adversarial inputs; the grouped-K mode bit-equal
                at W4A8's four dense shapes and fc1's four groups, each at M
                = 1, 8, 64, 128, 1024 and its own, int8-wide and packed,
                with the plan's cluster split and without, and on
                order-sensitive group scales, where a planted pairwise fold
                must differ; the packed-B mode bit-equal at the convnet's
                convs at bs1024 and bs1 under each of its plans (widened
                slots, four or two of them, cluster split)
  4. depthwise  K4 bit-equal at MobileNetV2's 17 depthwise shapes at bs256:
                int32, static int8, dynamic bf16, rounding ties, past the
                fast division's range; and at its tiling edge cases (torch
                pads at stride 2, odd H and W, N = 1, C = 8 and 20, wide)
  5. k1 stores  one forward of each model with every K1, K2, K3 and K4
                launch held against its plain version on the same inputs,
                bit for bit
  6. fused      K2 bit-equal to its plain version (fc1 / fc2 at bs1024 and
                bs32, MobileNetV2's fc at bs256; f32 and bf16 x; edge cases)
  7. boundary   K3 bit-equal, both variants, at its test and ResNet-50 shapes
  8. times      each kernel at its main-path shapes (CUDA events around
                back-to-back calls; K1's grouped and packed launches, their
                int8-wide yardsticks and K2 as device time, 20 launches in a
                CUDA graph, the back-to-back figure beside; the W4A8 convnet's
                bs1 rows at a bs1 forward's own calls; each such launch's
                plan), summed over one forward, beside its bound,
                its plain version, the PyTorch call that computes the same
                (torch._int_mm for K1's int32 store, F.conv2d for K4's: f32
                NCHW and channels_last, and bf16 channels_last, not exact)
                or the unfused route it replaced, and the host's cost of a
                call; K4 per shape with its GB/s and share of its bound, on
                the static and the dynamic MobileNetV2, as device time (20
                launches in a CUDA graph, replayed: at the 7x7 and 14x14
                shapes the host issues a call slower than the card runs it)
  9. paths      each model's forward with every count set to 0 just before it:
                launch counts, logits bit-equal to the plain-version forward,
                relative L2 to fp32, throughput and mfu ([main path], [static],
                [resnet50], [w4a8], [mobilenetv2], [mobilenetv2_dynamic],
                [resnet50 s2d] against the 7x7 int8-stem tree)
 10. schemes    fp32, dynamic, static, weight-only int8 and int4, bf16 and
                W4A8 from the same weights: artifact round trip bit-equal,
                the evaluator's counts held against the host's, agreement
                with fp32, bench at bs1 and bs32
 11. bench_torch  bench_torch.py's measurement in this process, its lines
 12. serve      the static convnet, static ResNet-50, the dynamic convnet and
                static MobileNetV2 served over the u8 wire through one CUDA
                graph per bucket: every replay bit-equal to an eager forward
                and launching, in a device trace of a replay on new inputs
                that is itself bit-equal to their eager forward, what the
                wrappers count in it; trickle and burst loads; every served
                request bit-equal
 13. observers  static ResNet-50 calibrated with the histogram and MSE observers
 14. accuracy   the accuracy tools at full width: MobileNetV2 1.0's optimized
                sweep (53 gated forwards, the quantized lanes through K1, K4
                and K2; the damage map bit-equal to the plain sweep's, the
                optimized logits bit-equal to their plain run); ResNet-50's
                cross-layer equalization, int4 guard, W4A8 AdaRound and bias
                correction (values within 1 LSB, the refined tree's forward
                bit-equal to its plain run)
 15. cli        python -m quantnet_torch in process: the reference convnet
                checkpoint import-torch -> quantize static -> evaluate ->
                bench -> serve; then quantize all with every accuracy tool ->
                evaluate the eight artifacts -> serve optimized; a
                torchvision MobileNetV2 state dict with quantize w4a8
 16. train      the convnet trained 2 epochs on the synthetic CIFAR-10 split
                (bs128, sgd_cosine, augmentation): finite losses, top-1 above
                chance; ResNet-50 and MobileNetV2 1.0, 10 train-mode steps at
                224x224 bs32: the loss falls, BN statistics move; the
                convnet's steps on the card and on the CPU from the same
                weights, batches and draws agree, per leaf above the max
                pools, and the same steps at PyTorch's TF32 defaults do not;
                img/s of each train step
 17. qat        QAT of the tracked trained convnet (runs/r3_cifar/saved fp32;
                and w4a8 by --init-from, its dense layers on K1's grouped-K
                mode), and a few QAT steps of ResNet-50 and MobileNetV2 at
                224x224: each baked tree's forward bit-equal to its plain
                run, every K1 / K3 / K4 launch bit-equal, its logits within
                the JAX QAT test's bound (the deep trees: a relative L2) of
                the fake-quant graph it deploys, and two planted bake faults
                outside it; fp32,
                static PTQ and QAT top-1; the QAT step's device-time split
                (torch.profiler); the PTQ-collapse demonstration
 18. cli train  python -m quantnet_torch train -> qat -> evaluate in process
 19. parallel   two spawned ranks sharing the card over gloo: the static
                convnet's sharded eval counts at bs1024 equal one process's;
                a convnet train step at bs256 (augmentation, dropout) against
                one process's on the global batch; cross-process calibration
                bit-identical on both ranks and equal to merge_all here; a
                Trainer epoch leaving both ranks' params bit-identical
 20. serve dp   the static convnet's engine over [cuda:0, cuda:0]: every
                response bit-equal to the one-replica engine's; trickle and
                burst beside the one replica's
 21. scaling    the weak-scaling sweep over the card count (n = 1 here)
 22. cli experiment  python -m quantnet_torch experiment -> report (again,
                byte for byte) -> scaling in process; then [cli s4]: qat to
                qat_w4a8 and qat_int4, and bench --s4-runtime with a row for
                every sub-byte tier
 23. s4         (after [accuracy]) the s4 runtime: the W4A8 convnet's 4-bit
                weights nibble-packed, K1 in its packed-B mode; logits
                bit-equal to the int8-wide tree's at bs1024 and bs1, the
                payloads' device bytes, p50 and graph-replay device time
                beside the int8-wide tree's;
                weight_only_int4 at bs32; the refined W4A8 ResNet-50 with
                every packed K1 and K3 launch held against its plain version
                (the s4 convnet's launches are held in [k1 stores], and
                timed in [times] beside the int8-wide launch)
 24. tensor parallel  (after [parallel]) two spawned ranks as a 1x2 mesh
                sharing the card over gloo: fc1 split by columns, fc2 by rows;
                the static and dynamic convnet bit-equal to one process's,
                W4A8 within its bound, the all-reduces' and the row
                epilogue's time per forward; an fp32 train step at bs256
                against one process's
 25. dryrun multichip  quantnet_torch.entry.dryrun_multichip(4): a 2x2 mesh
                of four ranks on the one card, the JAX line's keys checked
 26. cli imagenet  (after [cli experiment]) the ImageNet track through the
                CLI: --dataset imagenet resolves to ResNet-50, 224, 1000;
                experiment --importance static_map at full width on 256 / 256
                synthetic images; the static, dynamic and W4A8 artifacts'
                bs128 forwards, each launch counted against IMAGENET_LAUNCHES
                (static 54 K1: its int8 7x7 stem, 52 convs, the fc; 15 K3)
                and held bit-equal, the static logits bit-equal to the plain
                run; the optimized tree equal to quantize
                --importance static_map's; evaluate on a tiny decoded
                ImageFolder (or, without PIL, the loader naming it); p50 and
                img/s at bs128 beside [resnet50 bench]'s
 27. kernels    one JSON line with an entry per kernel and path (K1 on four
                paths, K1's grouped-K mode and its packed-B mode, normal and
                grouped, K2, K3, K4), its numbers, its
                launches through the serving engine, counted in device traces,
                the [accuracy] runs' launches, the baked QAT trees' ones and
                the data-parallel and tensor-parallel paths' (K1 on the
                static convnet) and [cli imagenet]'s, by model and artifact
Any failed check raises before the last line, which is the only place that
prints {"ok": true, ...}. Nothing is written outside build/ (gitignored).
"""
from __future__ import annotations

import contextlib
import functools
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
# Static INT8 convnet against its fp32 folded model, relative L2 of the
# logits (seed 0 weights, 32 calibration images, fp32 stem): a CPU rehearsal
# of this configuration at bs16 measured 0.0203; the bound leaves about 3x.
STATIC_FP32_REL_L2_MAX = 0.06
# The scheme matrix on the synthetic CIFAR-10 test split (2560 images): with
# random weights top-1 is chance, so each quantized scheme is held to the
# share of its predictions that equal fp32's. A CPU rehearsal of the same
# weights and split measured dynamic 0.9824, static 0.9797, weight_only
# 0.9918, weight_only_int4 0.8395, bf16 0.9965 and w4a8 0.9145; the floors
# leave 2-4 points.
SCHEME_AGREEMENT_MIN = {"dynamic": 0.95, "static": 0.95, "weight_only": 0.97,
                        "weight_only_int4": 0.80, "bf16": 0.97, "w4a8": 0.88}
SCHEME_BATCHES = (1, 32)
# K1's GEMMs on the static convnet beyond the dynamic one's convs (conv2-conv6
# are the same shapes): fc1 and fc2 at bs1024.
STATIC_FC_SHAPES = [("static_fc1", 1024, 4096, 512), ("static_fc2", 1024, 512, 10)]
# The paths whose K1 launches [times] times and the kernels line reports, one
# entry each; the W4A8 convnet's grouped-K launches get an entry of their own.
K1_PATHS = ("convnet", "convnet_static", "resnet50", "mobilenetv2")
# W4A8 (static.bake with weight_bits=4): the grouped-K mode of K1 at W4A8's
# dense layers with the CLI's default group (--int4-group-size 128): the
# convnet's fc1 and fc2 at bs1024, ResNet-50's fc at bs128 and MobileNetV2's
# fc at bs256 (name, M, K, N); fc1 also at every group the mode takes there.
W4A8_GROUP = 128
GROUPED_SHAPES = [("convnet_fc1", 1024, 4096, 512), ("convnet_fc2", 1024, 512, 10),
                  ("resnet50_fc", 128, 2048, 1000), ("mobilenetv2_fc", 256, 1280, 1000)]
FC1_GROUPS = (32, 64, 128, 256)
# W4A8 convnet (the static sibling's weights and calibration, fp32 stem, g128)
# against its fp32 folded model, relative L2 of the logits: a CPU rehearsal of
# this configuration at bs16 measured 0.2407 (4-bit weights on random ones);
# the bound leaves 1.5x.
W4A8_FP32_REL_L2_MAX = 0.36
# MobileNetV2 1.0 (1000 classes, random weights from seed 0) at 224x224, bs256:
# the size the JAX package benchmarks (docs/results_tpu_v5e_mobilenet_224).
MNV2_BATCH = 256
MNV2_IMAGE = 224
# Against the fp32 folded model, relative L2 of the logits: a CPU rehearsal at
# bs16 measured 0.0641 (static: min-max on 32 images, int8 stem) and 0.0669
# (dynamic); the bound leaves 2.3x.
MNV2_FP32_REL_L2_MAX = 0.15
# The accuracy tools ([accuracy]): one probe batch of 16 for the optimized
# sweep on MobileNetV2 1.0 and two for ResNet-50's int4 guard and W4A8
# calibration; AdaRound on those 32 images (ResNet-50's per-layer inputs
# and outputs are some 100 MB an image in f32: the JAX default of 512 would
# not fit on the card) for 100 steps.
ACCURACY_BATCH = 16
ADAROUND_STEPS = 100
ADAROUND_EXAMPLES = 32
# Cross-layer equalization keeps ResNet-50's function (ReLU, intra-block
# pairs), up to f32 rounding.
EQUALIZE_REL_L2_MAX = 1e-4
# The refined and corrected W4A8 ResNet-50 (4-bit weights on random ones)
# against fp32, relative L2 of the logits: a sanity bound; the figure is
# printed beside nearest rounding's.
W4A8_RESNET_REL_L2_MAX = 1.0
# K4's tiling edge cases beyond MobileNetV2's 17 shapes, (name, input NHWC,
# stride, pads): torch's (1, 1) pads at stride 2 (imported torchvision
# weights) at the four stride-2 shapes, odd H and W, one image, C = 8 and
# C = 20 (the masked variant), and an image wider than one block.
DW_EDGE_SHAPES = [
    ("torch_pad_block1", (MNV2_BATCH, 112, 112, 96), 2, ((1, 1), (1, 1))),
    ("torch_pad_block3", (MNV2_BATCH, 56, 56, 144), 2, ((1, 1), (1, 1))),
    ("torch_pad_block6", (MNV2_BATCH, 28, 28, 192), 2, ((1, 1), (1, 1))),
    ("torch_pad_block13", (MNV2_BATCH, 14, 14, 576), 2, ((1, 1), (1, 1))),
    ("odd_n1", (1, 57, 55, 144), 2, ((1, 1), (1, 1))),
    ("odd_s1", (3, 15, 13, 32), 1, ((1, 1), (1, 1))),
    ("c8", (2, 29, 29, 8), 1, ((1, 1), (1, 1))),
    ("c20", (2, 9, 9, 20), 2, ((0, 1), (0, 1))),
    ("wide", (1, 6, 600, 16), 1, ((1, 1), (1, 1))),
]
# Static ResNet-50 with the space-to-depth stem (int8 stem: K1 at K = 192)
# against the 7x7 tree with an int8 stem, both calibrated on the same images:
# the stems quantize to the same int8 weights and input domain, and the other
# layers' scales differ in the last places (the calibration forward's fp32
# stems sum in other orders). A CPU rehearsal at bs16 measured max |diff|
# 0.0080 x max|logit| and relative L2 0.0062; the bounds leave about 3x.
S2D_MAX_DIFF = 0.03
S2D_REL_L2_MAX = 0.02


# The serving engine (quantnet_torch/serve): one CUDA graph per bucket, the u8
# wire normalized on the card with the data's statistics. Trickle: requests
# one at a time, each awaited, with the 2 ms coalescing window and again
# without one (what a lone request costs beyond the window); burst: all
# submitted at once. Served logits are held against an eager forward of the
# same images at bs128: the same argmax, a relative L2 under
# SERVE_REL_L2_MAX, and bit-equal. The dynamic convnet is served in bursts of
# whole 128-request batches (one bucket, a long coalescing window), so each
# batch is the same batch as its reference (its convs' activation scale is
# per batch); the static engines' rows are independent of their batch-mates
# but for the fp32 stem's cuDNN algorithm, which may change with the batch
# size; on an H100 it did not, so they are held bit-equal too.
SERVE_BUCKETS = (1, 8, 32, 128)
TRICKLE_REQUESTS = 64
SERVE_REL_L2_MAX = 1e-3
CIFAR10_MEAN, CIFAR10_STD = (0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# (path, image size, burst requests, buckets, max_wait_ms, trickle, normalize)
SERVED = [
    ("convnet_static", 32, 1024, SERVE_BUCKETS, 2.0, True, (CIFAR10_MEAN, CIFAR10_STD)),
    ("resnet50", RESNET_IMAGE, 512, SERVE_BUCKETS, 2.0, True, (IMAGENET_MEAN, IMAGENET_STD)),
    ("convnet", 32, 512, (128,), 2000.0, False, (CIFAR10_MEAN, CIFAR10_STD)),
    ("mobilenetv2", MNV2_IMAGE, 512, SERVE_BUCKETS, 2.0, True, (IMAGENET_MEAN, IMAGENET_STD)),
]


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


def device_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device ms per call: `launches` calls captured in one CUDA graph and
    the graph replayed `replays` times between CUDA events, after a warm-up
    (the host's cost of a call left out: what a forward that queues its
    launches ahead sees)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


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
    check(set(libs) == set(_build.LIBRARIES), f"built {sorted(libs)}")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "wgmma", "warning")):
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
        ("convnet_static",) + s for s in STATIC_FC_SHAPES] + [
        ("resnet50", f"resnet50_{m}x{k}x{n}", m, k, n) for m, k, n in sorted(gemms)
    ]
    err = {"convnet": 0.0, "convnet_static": 0.0, "resnet50": 0.0}
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
    err["convnet_static"] = max(err["convnet_static"], err["convnet"])  # conv2-conv6 shared
    err["grouped"], n_grouped, grouped_plans, caught = grouped_check(torch, dev)
    n_packed, packed_plans = packed_check(torch, dev)
    phase("int8_gemm", t0, f"int32 store exact against int8_gemm_plain at {len(shapes)} shapes "
          f"({len(gemms)} of them ResNet-50's at bs{RESNET_BATCH}); the int8 store's division "
          f"bit-equal to quantize_affine on {n_div} inputs in {len(REQUANTIZE_DOMAINS)} domains; "
          f"the grouped-K mode (W4A8) bit-equal to its plain version in {n_grouped} cases: "
          f"{', '.join(n for n, *_ in GROUPED_SHAPES)} at g{W4A8_GROUP} and fc1 at g"
          f"{', '.join(map(str, FC1_GROUPS))}, each at its rows and M = "
          f"{', '.join(map(str, GROUPED_ROWS))}, int8-wide and packed, f32 and int8 stores, plans: "
          f"{'; '.join(grouped_plans)}; order-sensitive scales bit-equal, a planted pairwise fold "
          f"caught at {', '.join(caught)}; the packed-B mode bit-equal in {n_packed} cases at the "
          f"convnet's convs at bs{BATCH} and bs1, plans: {'; '.join(packed_plans)}")
    return err


def grouped_epilogue(torch, dev, g, m, k, n, group, store):
    """A W4A8 layer's epilogue in the grouped-K mode: 4-bit-range scales
    and zero-point corrections per group, the activation scale, a bias; the
    f32 store, or relu and the int8 store."""
    from quantnet_torch.core.types import ActQuant
    from quantnet_torch.ops.int8_matmul import Epilogue

    groups = k // group
    gs = torch.rand((groups, n), generator=g, device=dev) * 1e-2 + 1e-4
    gzpw = torch.randint(-30000, 30000, (groups, n), generator=g, device=dev, dtype=torch.int32)
    cs = torch.full((n,), 0.0371, device=dev)
    bias = torch.randn((n,), generator=g, device=dev)
    if store == "int8":
        oq = ActQuant(torch.tensor(0.0613, device=dev), torch.tensor(-11, dtype=torch.int32, device=dev))
        return Epilogue(cs=cs, bias=bias, act="relu", out=torch.int8, out_quant=oq, group=group,
                        gs=gs, gzpw=gzpw)
    return Epilogue(cs=cs, bias=bias, group=group, gs=gs, gzpw=gzpw)


# The rows the grouped-K mode is held at, beside each shape's own: a bs1
# forward's, small batches, one tile, the bench's batch.
GROUPED_ROWS = (1, 8, 64, 128, 1024)


def _same_bits(torch, got, ref) -> int:
    """How many elements differ, compared as integers (-0 against +0 counts)."""
    bits = {torch.float32: torch.int32, torch.int8: torch.int8, torch.bfloat16: torch.int16}
    return int((got.contiguous().view(bits[got.dtype]) != ref.contiguous().view(bits[ref.dtype])).sum())


def _plan_kind(plan) -> str:
    return f"BN {plan.bn} {plan.stages} stages {plan.slots} slots split {plan.split}"


def _pairwise_fold(torch, a, b, epi):
    """A planted reorder of the grouped mode's f32 fold: the same t_g summed
    pairwise, ((t0 + t1) + (t2 + t3)) + ..., then the epilogue."""
    from quantnet_torch.ops.int8_matmul import finish_epilogue, int8_gemm_plain

    ts = [(int8_gemm_plain(a[:, q:q + epi.group], b[:, q:q + epi.group]) - epi.gzpw[q // epi.group]).float()
          * epi.gs[q // epi.group] for q in range(0, a.shape[1], epi.group)]
    while len(ts) > 1:
        ts = [ts[i] + ts[i + 1] if i + 1 < len(ts) else ts[i] for i in range(0, len(ts), 2)]
    return finish_epilogue((torch.zeros_like(ts[0]) + ts[0]) * epi.cs, epi)


def grouped_check(torch, dev):
    """K1's grouped-K mode against its plain version, bit for bit (compared
    as integers), on int8 activations and 4-bit weights, int8-wide and
    nibble-packed: every GROUPED_SHAPES entry and fc1 at every FC1_GROUPS
    group, each at its own rows and at GROUPED_ROWS, f32 and int8 stores,
    with the plan's split and with none; then on inputs whose group scales
    make the f32 order matter (grouped_order_epilogue), where a planted
    pairwise fold of the same terms must differ from the plain version.
    Returns (max |diff|, cases, the plans met)."""
    from quantnet_torch.core.types import pack_nibbles
    from quantnet_torch.ops.int8_matmul import (
        _STORES,
        grouped_order_epilogue,
        int8_gemm_epilogue,
        int8_gemm_epilogue_plain,
        k1_plan,
        launch_plan,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    shapes = [(name, k, n, W4A8_GROUP) for name, _, k, n in GROUPED_SHAPES] + [
        ("convnet_fc1", 4096, 512, group) for group in FC1_GROUPS if group != W4A8_GROUP]
    rows = {name: m for name, m, _, _ in GROUPED_SHAPES}
    err, n_cases, plans = 0.0, 0, set()
    for name, k, n, group in shapes:
        b = torch.randint(-7, 8, (n, k), generator=g, device=dev, dtype=torch.int8)
        packed = pack_nibbles(b)
        for m in sorted({rows[name], *GROUPED_ROWS}):
            a = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
            for store in ("f32", "int8"):
                epi = grouped_epilogue(torch, dev, g, m, k, n, group, store)
                ref = int8_gemm_epilogue_plain(a, b, epi)
                for bb in (b, packed):
                    plan = launch_plan(a, bb, epi)
                    variants = [None] + ([k1_plan(m, n, k, _STORES[epi.out], group, bb is packed, split=1)]
                                         if plan.split > 1 else [])
                    for forced in variants:
                        got = int8_gemm_epilogue(a, bb, epi, plan=forced)
                        torch.cuda.synchronize()
                        bad = _same_bits(torch, got, ref)
                        err = max(err, (got.float() - ref.float()).abs().max().item())
                        check(bad == 0, f"int8_gemm grouped {name} {m}x{k}x{n} g{group} {store} "
                              f"{'packed' if bb is packed else 'int8-wide'} ({forced or plan}): {bad} of "
                              f"{ref.numel()} differ from the plain version")
                        plans.add(_plan_kind(forced or plan))
                        n_cases += 1
    # The fold's order: inputs where it shows, the kernel still bit-equal,
    # a pairwise fold of the same t_g not.
    caught = []
    for m, k, n, group in ((1, 4096, 512, 128), (64, 4096, 512, 32), (1024, 4096, 512, 128),
                           (128, 2048, 1000, 128)):
        a = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        b = torch.randint(-7, 8, (n, k), generator=g, device=dev, dtype=torch.int8)
        epi = grouped_order_epilogue(m, k, n, group, torch.float32, dev, seed=m + group)
        ref = int8_gemm_epilogue_plain(a, b, epi)
        for bb in (b, pack_nibbles(b)):
            bad = _same_bits(torch, int8_gemm_epilogue(a, bb, epi), ref)
            check(bad == 0, f"int8_gemm grouped {m}x{k}x{n} g{group}, order-sensitive scales "
                  f"({launch_plan(a, bb, epi)}): {bad} of {ref.numel()} differ from the plain version")
            n_cases += 1
        planted = _same_bits(torch, _pairwise_fold(torch, a, b, epi), ref)
        check(planted > 0, f"the planted pairwise fold at {m}x{k}x{n} g{group} equals the plain "
              "version: the grouped check could not fail")
        caught.append(f"{m}x{k}x{n} g{group} {planted} of {ref.numel()}")
    return err, n_cases, sorted(plans), caught


def packed_check(torch, dev):
    """K1's packed-B mode against its plain version, bit for bit, at the
    W4A8 convnet's convs at bs1024 and at a bs1 forward's shapes (int8
    store with zero point, bias and relu; f32 store), under every plan the
    mode has there: the default (four widened slots, or a cluster split),
    two slots, and no split where the default splits. Returns (cases,
    plans met)."""
    from quantnet_torch.core.types import ActQuant, pack_nibbles
    from quantnet_torch.ops.int8_matmul import (
        _STORES,
        Epilogue,
        int8_gemm_epilogue,
        int8_gemm_epilogue_plain,
        k1_plan,
        launch_plan,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    n_cases, plans = 0, set()
    for _, m1024, k, n in CONV_SHAPES[1:]:
        w = torch.randint(-8, 8, (n, k), generator=g, device=dev, dtype=torch.int8)
        b = pack_nibbles(w)
        for m in (m1024, m1024 // BATCH):
            a = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
            for store in ("int8", "f32"):
                cs = torch.rand((n,), generator=g, device=dev) * 1e-3
                bias = torch.randn((n,), generator=g, device=dev)
                zpw = torch.randint(-9000, 9000, (n,), generator=g, device=dev, dtype=torch.int32)
                epi = (Epilogue(cs=cs, bias=bias, zpw=zpw, act="relu", out=torch.int8,
                                out_quant=ActQuant(torch.tensor(0.05, device=dev),
                                                   torch.tensor(-128, dtype=torch.int32, device=dev)))
                       if store == "int8" else Epilogue(cs=cs, bias=bias, zpw=zpw))
                ref = int8_gemm_epilogue_plain(a, b, epi)
                code = _STORES[epi.out]
                plan = launch_plan(a, b, epi)
                variants = {plan, k1_plan(m, n, k, code, packed=True, split=plan.split, slots=2)}
                if plan.split > 1:
                    variants.add(k1_plan(m, n, k, code, packed=True, split=1))
                for plan in sorted(variants, key=str):
                    got = int8_gemm_epilogue(a, b, epi, plan=plan)
                    torch.cuda.synchronize()
                    bad = _same_bits(torch, got, ref)
                    check(bad == 0, f"int8_gemm packed {m}x{k}x{n} {store} ({plan}): {bad} of "
                          f"{ref.numel()} differ from the plain version")
                    plans.add(_plan_kind(plan))
                    n_cases += 1
            del a
    return n_cases, sorted(plans)


def mobilenet_dw_shapes(batch: int, image: int):
    """MobileNetV2 1.0's 17 depthwise convs at (batch, image): (name, input
    NHWC shape, stride, pads), XLA's SAME pads as the model runs them."""
    from quantnet_torch.models.mobilenet import block_widths
    from quantnet_torch.ops.conv import _same_pads

    _, _, blocks = block_widths(1.0)
    h = -(-image // 2)  # the stem, 3x3/2 SAME
    out = []
    for i, (_, hidden, _, stride) in enumerate(blocks):
        out.append((f"block{i}", (batch, h, h, hidden), stride, _same_pads(h, h, 3, 3, stride)))
        h = -(-h // stride)
    return out


def depthwise_phase(torch, dev):
    """K4 against its plain version at MobileNetV2's 17 depthwise shapes at
    bs256, bit for bit: the int32 accumulator; the static store (zero-point
    pad, - zpw, relu6, int8 in the consumer's domain); the dynamic store
    (zero pad, relu6, the bf16 handoff); the int8 store on the requantize's
    hard inputs: every accumulator an exact multiple of the scale, 1/128 of
    them on a rounding tie of y / out_s, and (at two shapes) a domain past
    the fast division's range. Then the tiling's edge cases (DW_EDGE_SHAPES)
    with the int32, static int8, dynamic bf16 and f32 stores."""
    from quantnet_torch.core.types import ActQuant
    from quantnet_torch.ops.depthwise_conv import depthwise_conv, depthwise_conv_plain
    from quantnet_torch.ops.int8_matmul import Epilogue

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    bits = {torch.int32: torch.int32, torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8}
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    err, n_cases = 0.0, 0
    shapes = mobilenet_dw_shapes(MNV2_BATCH, MNV2_IMAGE)
    for i, (name, shape, stride, pads) in enumerate(shapes + DW_EDGE_SHAPES):
        c = shape[3]
        x = torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (3, 3, 1, c), generator=g, device=dev, dtype=torch.int8)
        cs = torch.rand((c,), generator=g, device=dev) * 1e-3 + 1e-5
        bias = torch.randn((c,), generator=g, device=dev)
        zpw = torch.randint(-3000, 3000, (c,), generator=g, device=dev, dtype=torch.int32)
        cases = [
            ("int32", 0, None),
            ("static int8", -9, Epilogue(cs=cs, bias=bias, zpw=zpw, act="relu6", out=torch.int8,
                                         out_quant=ActQuant(f32(0.0517), i32(-3)))),
            ("dynamic bf16", 0, Epilogue(cs=cs, bias=bias, act="relu6", out=torch.bfloat16)),
        ]
        if i < len(shapes):
            cases.append(("ties int8", -9, Epilogue(cs=torch.full((c,), 2.0**-14, device=dev), zpw=zpw,
                                                    out=torch.int8,
                                                    out_quant=ActQuant(f32(2.0**-7), i32(5)))))
        else:
            cases.append(("f32", 5, Epilogue(cs=cs, zpw=zpw)))
        if i < 2:
            cases.append(("slow int8", 0, Epilogue(cs=torch.full((c,), 2.0**-80, device=dev),
                                                   out=torch.int8,
                                                   out_quant=ActQuant(f32(2.0**-70), i32(3)))))
        for kind, pad_value, epi in cases:
            got = depthwise_conv(x, w, stride, pads, pad_value, epi)
            torch.cuda.synchronize()
            ref = depthwise_conv_plain(x, w, stride, pads, pad_value, epi)
            check(got.dtype == ref.dtype and got.shape == ref.shape,
                  f"depthwise {name} {kind}: {got.dtype}{tuple(got.shape)}")
            bad = int((got.view(bits[got.dtype]) != ref.view(bits[ref.dtype])).sum())
            err = max(err, (got.float() - ref.float()).abs().max().item())
            check(bad == 0, f"depthwise_conv {name} {tuple(shape)} stride {stride} pads {pads} {kind}: "
                  f"{bad} of {ref.numel()} differ from the plain version")
            n_cases += 1
        del x, got, ref
    phase("depthwise", t0, f"K4 bit-equal to depthwise_conv_plain in {n_cases} cases: MobileNetV2's "
          f"{len(shapes)} depthwise shapes at bs{MNV2_BATCH} {MNV2_IMAGE}x{MNV2_IMAGE} (C 32 to 960, "
          "stride 1 and 2), the int32 accumulator, the static int8 and dynamic bf16 stores with "
          "relu6, the int8 store on rounding ties and past the fast division's range; "
          f"{len(DW_EDGE_SHAPES)} tiling edge cases ({', '.join(n for n, *_ in DW_EDGE_SHAPES)}) with "
          "the int32, static int8, dynamic bf16 and f32 stores")
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
    for name, m, k, n, _ in FC_SHAPES + [("mobilenetv2_fc", MNV2_BATCH, 1280, 1000, "bfloat16")]:
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
          f"at bs{' and bs'.join(map(str, FC_BATCHES))}, MobileNetV2's fc at bs{MNV2_BATCH} "
          "(K = 1280: two 512-wide K-blocks and a zero-padded one), f32 and bf16 x, relu on and "
          "off, random x and fused_dynamic_cases")
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


def _time_k1_grouped(torch, a, b, epi, iters):
    """{ms, back_to_back, unfused, plain} ms of one launch of K1's grouped-K
    mode: the fused launch as device time (device_ms: at bs1 and at fc2 a
    call is shorter than the host's cost of issuing it) and as back-to-back
    calls (time_ms, which times the host below ~30 us a call); the route it
    replaces, one int32 launch of K1 per group on the group's K-slice
    (sliced beforehand) and the combine in PyTorch ops; the plain version."""
    from quantnet_torch.ops.int8_matmul import (
        finish_epilogue,
        grouped_accumulate,
        int8_gemm,
        int8_gemm_epilogue,
        int8_gemm_epilogue_plain,
    )

    k, grp = a.shape[1], epi.group
    slices = {lo: (a[:, lo:lo + grp].contiguous(), b[:, lo:lo + grp].contiguous())
              for lo in range(0, k, grp)}

    def unfused():
        y = grouped_accumulate(lambda lo, hi: int8_gemm(*slices[lo]), k, epi)
        return finish_epilogue(y * epi.cs, epi)

    return {"ms": device_ms(lambda: int8_gemm_epilogue(a, b, epi)),
            "back_to_back": time_ms(lambda: int8_gemm_epilogue(a, b, epi), iters),
            "unfused": time_ms(unfused, iters),
            "plain": time_ms(lambda: int8_gemm_epilogue_plain(a, b, epi), max(iters // 4, 3))}


def _time_k1_packed(torch, a, b, epi, iters):
    """{ms, wide, back_to_back, wide_back_to_back, plain} ms of one launch of
    K1's packed-B mode: the packed launch and the same launch on the widened
    weight (the yardstick), each as device time (device_ms) and as
    back-to-back calls (time_ms); the plain version."""
    from quantnet_torch.core.types import unpack_nibbles
    from quantnet_torch.ops.int8_matmul import int8_gemm_epilogue, int8_gemm_epilogue_plain

    wide = unpack_nibbles(b)
    return {"ms": device_ms(lambda: int8_gemm_epilogue(a, b, epi)),
            "wide": device_ms(lambda: int8_gemm_epilogue(a, wide, epi)),
            "back_to_back": time_ms(lambda: int8_gemm_epilogue(a, b, epi), iters),
            "wide_back_to_back": time_ms(lambda: int8_gemm_epilogue(a, wide, epi), iters),
            "plain": time_ms(lambda: int8_gemm_epilogue_plain(a, b, epi), max(iters // 4, 3))}


def _plans(a, b, epi) -> str:
    """The launch plan of a K1 call (and, for a packed B, of the int8-wide
    launch on its widened weight)."""
    from quantnet_torch.core.types import unpack_nibbles
    from quantnet_torch.ops.int8_matmul import is_packed, launch_plan

    text = f"plan {launch_plan(a, b, epi)}"
    if is_packed(b):
        text += f"; int8-wide plan {launch_plan(a, unpack_nibbles(b), epi)}"
    return text


def _k1_calls_at(torch, m, rows):
    """The K1 calls of one forward of a model on its first `rows` images,
    each held bit-equal to its plain version (held_launches), by (M, K, N,
    store) -> [count, a, b, epi]."""
    with held_launches(torch) as rec:
        m["apply"](m["q"], m["qs"], m["x"][:rows])
    return rec["calls"]["int8_gemm"]


def _k1_fused_bytes(a, b, epi) -> int:
    """A and B read once, the per-column (and per-row, and the grouped
    mode's per-group) vectors read once, the output written once in its own
    type."""
    m, n = a.shape[0], b.shape[0]
    vectors = sum(t.numel() * t.element_size()
                  for t in (epi.cs, epi.bias, epi.zpw, epi.rs, epi.gs, epi.gzpw) if t is not None)
    return a.numel() + b.numel() + vectors + m * n * epi.out.itemsize


def _time_depthwise(torch, x, w, stride, pads, pad_value, epi, iters):
    """(kernel as launched, int32 store, back-to-back, plain, library) ms of
    one K4 call: its fused store and its int32 store as device time
    (device_ms: at MobileNetV2's 7x7 and 14x14 shapes a call takes the host
    longer to issue than the card to run), the fused store's back-to-back
    calls between CUDA events (time_ms, as earlier runs timed it), the plain
    version, and the PyTorch yardsticks: one F.conv2d (pre-padded, groups =
    C, TF32 off) of the values widened to f32 in NCHW and in channels_last
    (both exact), and in bf16 channels_last (the same work, not exact: the
    products round), each between CUDA events."""
    import torch.nn.functional as F

    from quantnet_torch.ops.depthwise_conv import depthwise_conv, depthwise_conv_plain

    ms = device_ms(lambda: depthwise_conv(x, w, stride, pads, pad_value, epi))
    int32_ms = device_ms(lambda: depthwise_conv(x, w, stride, pads, pad_value))
    events_ms = time_ms(lambda: depthwise_conv(x, w, stride, pads, pad_value, epi), iters)
    plain = time_ms(lambda: depthwise_conv_plain(x, w, stride, pads, pad_value, epi), max(iters // 4, 3))
    (pt, pb), (pl, pr) = pads
    xf = F.pad(x.float().permute(0, 3, 1, 2), (pl, pr, pt, pb), value=float(pad_value)).contiguous()
    wf = w.float().permute(3, 2, 0, 1).contiguous()
    cudnn = torch.backends.cudnn
    lib = {}
    with cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
        for name, dtype, fmt in (("nchw_f32", torch.float32, torch.contiguous_format),
                                 ("nhwc_f32", torch.float32, torch.channels_last),
                                 ("nhwc_bf16", torch.bfloat16, torch.channels_last)):
            xl = xf.to(dtype).contiguous(memory_format=fmt)
            wl = wf.to(dtype).contiguous(memory_format=fmt)
            lib[name] = time_ms(lambda: F.conv2d(xl, wl, stride=stride, groups=x.shape[3]), iters)
            del xl
    return ms, int32_ms, events_ms, plain, lib


def _depthwise_bytes(shape, stride, w, epi):
    """(bytes, operations) of one K4 call: x read once, the weight and the
    vectors read once, y written once in its type; 2 x 9 integer operations
    an output on the CUDA cores (not the tensor cores: held to the f32
    rate), so bound by bytes at every shape."""
    out = shape[0] * (-(-shape[1] // stride)) * (-(-shape[2] // stride)) * shape[3]
    vectors = 0 if epi is None else sum(
        t.numel() * t.element_size() for t in (epi.cs, epi.bias, epi.zpw) if t is not None)
    itemsize = 4 if epi is None else epi.out.itemsize
    return math.prod(shape) + w.numel() + vectors + out * itemsize, 18 * out


def _time_k4_path(torch, calls, label):
    """K4 at one path's depthwise calls: per shape its time, GB/s and share
    of its bound, its int32 store, plain version and yardsticks; summed over
    the forward's launches into (as launched, int32 store) sums, with the
    yardsticks beside."""
    acc, acc32 = _sums(), _sums()
    lib_sum = {"events": 0.0}
    for (shape, stride, store), (count, x, w, _, pads, pad_value, epi) in sorted(calls.items()):
        ms, int32_ms, events_ms, plain, lib = _time_depthwise(torch, x, w, stride, pads, pad_value, epi, 20)
        nbytes, ops = _depthwise_bytes(shape, stride, w, epi)
        nbytes32, _ = _depthwise_bytes(shape, stride, w, None)
        b_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        b32_ms = max(nbytes32 / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        fastest = min(lib.values())
        print(f"  depthwise_conv {label} {'x'.join(map(str, shape))} stride {stride} {store} x{count}: "
              f"kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.1%} of its bound "
              f"{b_ms:.4f} ms; back-to-back calls {events_ms:.4f} ms), int32 store {int32_ms:.4f} ms "
              f"({b32_ms / int32_ms:.1%} of "
              f"{b32_ms:.4f}), plain {plain:.4f} ms, F.conv2d f32 NCHW {lib['nchw_f32']:.4f} ms, "
              f"f32 channels_last {lib['nhwc_f32']:.4f} ms, bf16 channels_last "
              f"{lib['nhwc_bf16']:.4f} ms{'' if int32_ms <= fastest else ' (slower than F.conv2d)'}")
        for a, t, nb in ((acc, ms, nbytes), (acc32, int32_ms, nbytes32)):
            _add(a, count, t, plain, nb, 0, lib["nchw_f32"])
            a["ops_ms"] += count * ops / F32_OPS_PER_S * 1e3
            a["bound_ms"] += count * max(0.0, ops / F32_OPS_PER_S * 1e3 - nb / HBM_BYTES_PER_S * 1e3)
        for k, v in lib.items():
            lib_sum[k] = lib_sum.get(k, 0.0) + count * v
        lib_sum["events"] += count * events_ms
    return acc, acc32, lib_sum


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


def times_phase(torch, dev, k1_calls, dw_calls, models):
    """Per-shape times; returns the per-forward sums of each kernel: K1 on
    each path (its int32 store, and as the path launches it; the grouped-K
    mode apart), K2 on the convnet at each of FC_BATCHES (and its ms on the
    forward's own inputs, and its host cost) and at MobileNetV2's fc, K3 on
    ResNet-50, K4 on MobileNetV2."""
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm, fused_dynamic_gemm_plain
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.ops.residual_boundary import residual_boundary, residual_boundary_plain

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    k1_int32 = {path: _sums() for path in K1_PATHS}
    k1 = {path: _sums() for path in K1_PATHS}
    k2 = {batch: _sums() for batch in FC_BATCHES}
    k2_own = {batch: 0.0 for batch in FC_BATCHES}
    k2_b2b = {batch: 0.0 for batch in FC_BATCHES}
    k3 = _sums()
    gemms, boundaries = resnet_shapes(RESNET_BATCH, RESNET_IMAGE)
    # The int32 store at the K the kernel runs (conv1's 27 padded to 32;
    # the padded bytes count in the bound).
    int32_shapes = [("convnet", 1, m, -(-k // 16) * 16, n, 30) for _, m, k, n in CONV_SHAPES] + [
        (path, count, m, k, n, 30) for path in ("convnet_static", "mobilenetv2")
        for (m, k, n, _), (count, *_) in sorted(k1_calls[path].items())] + [
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
    for path in K1_PATHS:
        for (m, k, n, store), (count, a, b, epi) in sorted(k1_calls[path].items()):
            ms, unfused, plain = _time_k1_fused(torch, a, b, epi, 20)
            nbytes, ops = _k1_fused_bytes(a, b, epi), 2 * m * n * k
            print(f"  int8_gemm {path} {store} {m}x{k}x{n} x{count}: kernel {ms:.4f} ms, bound "
                  f"{bound(nbytes, ops)[0]:.4f} ms ({bound(nbytes, ops)[1]}), unfused route "
                  f"{unfused:.4f} ms, plain {plain:.4f} ms")
            _add(k1[path], count, ms, plain, nbytes, ops, unfused)
    # The W4A8 convnet's grouped-K launches (fc1 and fc2), at bs1024 and at
    # a bs1 forward's own shapes (M = 1), as device time; the back-to-back
    # figure beside it. library_ms holds the unfused route.
    k1g = {key: dict(_sums(), back_to_back_ms=0.0) for key in ("bs1024", "bs1")}
    plans = {"grouped": [], "packed_normal": [], "packed_grouped": []}
    wide_calls = {"bs1024": k1_calls["convnet_w4a8"], "bs1": _k1_calls_at(torch, models["convnet_w4a8"], 1)}
    for key, calls in wide_calls.items():
        for (m, k, n, store), (count, a, b, epi) in sorted(calls.items()):
            if epi.group is None:
                continue  # the W4A8 convnet's convs: the static sibling's shapes
            t = _time_k1_grouped(torch, a, b, epi, 20)
            nbytes, ops = _k1_fused_bytes(a, b, epi), 2 * m * n * k
            print(f"  int8_gemm convnet_w4a8 {store} {m}x{k}x{n} x{count}: kernel {t['ms']:.4f} ms "
                  f"device (back-to-back calls {t['back_to_back']:.4f} ms), bound "
                  f"{bound(nbytes, ops)[0]:.4f} ms ({bound(nbytes, ops)[1]}), unfused route "
                  f"{t['unfused']:.4f} ms, plain {t['plain']:.4f} ms; {_plans(a, b, epi)}")
            _add(k1g[key], count, t["ms"], t["plain"], nbytes, ops, t["unfused"])
            plans["grouped"].append(f"{m}x{k}x{n} {store}: {_plans(a, b, epi)}")
            k1g[key]["back_to_back_ms"] += count * t["back_to_back"]
    # K1's packed-B mode at the W4A8 convnet's calls under the s4 runtime, at
    # bs1024 and at a bs1 forward's own shapes (the convs at M = H x W of one
    # image, fc1 and fc2 at M = 1), as device time; the bound counts the
    # packed weight's bytes; library_ms holds the int8-wide launch's device
    # time, and the back-to-back figures sit beside both.
    k1p = {key: dict(_sums(), back_to_back_ms=0.0, wide_back_to_back_ms=0.0)
           for key in ("normal", "grouped", "normal_bs1", "grouped_bs1")}
    s4_calls = {"": k1_calls["convnet_w4a8_s4"], "_bs1": _k1_calls_at(torch, models["convnet_w4a8_s4"], 1)}
    for suffix, calls in s4_calls.items():
        for (m, k, n, store), (count, a, b, epi) in sorted(calls.items()):
            check(b.dtype == torch.uint8, f"[times] the s4 tree's K1 call {m}x{k}x{n} got {b.dtype}")
            key = ("grouped" if epi.group is not None else "normal") + suffix
            t = _time_k1_packed(torch, a, b, epi, 20)
            nbytes, ops = _k1_fused_bytes(a, b, epi), 2 * m * n * k
            print(f"  int8_gemm packed {store} {m}x{k}x{n} x{count}: kernel {t['ms']:.4f} ms device "
                  f"(back-to-back calls {t['back_to_back']:.4f} ms), bound {bound(nbytes, ops)[0]:.4f} ms "
                  f"({bound(nbytes, ops)[1]}, packed weight {b.numel()} bytes), int8-wide launch "
                  f"{t['wide']:.4f} ms device (back-to-back {t['wide_back_to_back']:.4f} ms), plain "
                  f"{t['plain']:.4f} ms; {_plans(a, b, epi)}")
            _add(k1p[key], count, t["ms"], t["plain"], nbytes, ops, t["wide"])
            plans["packed_" + key.replace("_bs1", "")].append(f"{m}x{k}x{n} {store}: {_plans(a, b, epi)}")
            k1p[key]["back_to_back_ms"] += count * t["back_to_back"]
            k1p[key]["wide_back_to_back_ms"] += count * t["wide_back_to_back"]
    own = k2_operands(torch, models["convnet"])
    k2_shapes = FC_SHAPES + [("mobilenetv2_fc", MNV2_BATCH, 1280, 1000, "bfloat16")]
    k2_mnv2 = _sums()
    for name, m, k, n, dtype in k2_shapes:
        args = fused_inputs(torch, dev, m, k, n, g, dtype) + (name == "fc1",)  # fc1's relu
        ms = device_ms(lambda: fused_dynamic_gemm(*args))
        b2b = time_ms(lambda: fused_dynamic_gemm(*args))
        plain = time_ms(lambda: fused_dynamic_gemm_plain(*args))
        nbytes = args[0].element_size() * m * k + k * n + 8 * n + 4 * m * n
        ops = 2 * m * n * k
        own_ms = None
        if name in ("fc1", "fc2"):
            own_args = own[m][name]
            check(tuple(own_args[0].shape) == (m, k) and own_args[0].dtype == args[0].dtype,
                  f"{name} bs{m} takes {tuple(own_args[0].shape)} {own_args[0].dtype} in the forward")
            own_ms = device_ms(lambda: fused_dynamic_gemm(*own_args))
            _add(k2[m], 1, ms, plain, nbytes, ops)
            k2_own[m] += own_ms
            k2_b2b[m] += b2b
        else:
            _add(k2_mnv2, 1, ms, plain, nbytes, ops)
            k2_b2b["mobilenetv2_fc"] = b2b
        print(f"  fused_dynamic_gemm {name} {m}x{k}x{n} {dtype} x: kernel {ms:.4f} ms device "
              f"(back-to-back calls {b2b:.4f} ms)"
              f"{'' if own_ms is None else f' (on the forward own input {own_ms:.4f} ms)'}, bound "
              f"{bound(nbytes, ops)[0]:.4f} ms ({bound(nbytes, ops)[1]}), plain {plain:.4f} ms")
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
    k4, k4_int32, k4_lib = _time_k4_path(torch, dw_calls["mobilenetv2"], "mobilenetv2")
    k4_dyn, _, _ = _time_k4_path(torch, dw_calls["mobilenetv2_dynamic"], "mobilenetv2_dynamic")
    per_path = "; ".join(
        f"int8_gemm {p} int32 {k1_int32[p]['ms']:.4f} ms (bound {k1_int32[p]['bound_ms']:.4f}, "
        f"torch._int_mm {k1_int32[p]['library_ms']:.4f}), as launched {k1[p]['ms']:.4f} ms (bound "
        f"{k1[p]['bound_ms']:.4f}, unfused route {k1[p]['library_ms']:.4f})"
        for p in K1_PATHS)
    per_batch = "; ".join(
        f"fused_dynamic_gemm bs{bt} {k2[bt]['ms']:.4f} ms (own inputs {k2_own[bt]:.4f}, bound "
        f"{k2[bt]['bound_ms']:.4f}, plain {k2[bt]['plain_ms']:.4f})" for bt in FC_BATCHES)
    grouped = ", ".join(
        f"{key} {v['ms']:.4f} ms device (back-to-back {v['back_to_back_ms']:.4f}, bound "
        f"{v['bound_ms']:.4f}, unfused route {v['library_ms']:.4f}, plain {v['plain_ms']:.4f})"
        for key, v in k1g.items())
    packed = ", ".join(
        f"{key} {v['ms']:.4f} ms device (back-to-back {v['back_to_back_ms']:.4f}, bound "
        f"{v['bound_ms']:.4f}, int8-wide {v['library_ms']:.4f} device, back-to-back "
        f"{v['wide_back_to_back_ms']:.4f})" for key, v in k1p.items())
    phase("times", t0, f"per forward: {per_path}; int8_gemm grouped (W4A8 convnet) {grouped}; "
          f"int8_gemm packed (W4A8 convnet, s4) {packed}; {per_batch} (device time; back-to-back "
          f"{', '.join(f'bs{bt} {k2_b2b[bt]:.4f}' for bt in FC_BATCHES)}); fused_dynamic_gemm "
          f"mobilenetv2 fc {k2_mnv2['ms']:.4f} ms device (back-to-back {k2_b2b['mobilenetv2_fc']:.4f}, "
          f"bound {k2_mnv2['bound_ms']:.4f}); residual_boundary "
          f"{k3['ms']:.4f} ms (bound {k3['bound_ms']:.4f}, plain {k3['plain_ms']:.4f}); "
          f"depthwise_conv mobilenetv2 {k4['ms']:.4f} ms of device time (bound {k4['bound_ms']:.4f}, "
          f"{k4['bound_ms'] / k4['ms']:.1%}; back-to-back calls {k4_lib['events']:.4f}; int32 store "
          f"{k4_int32['ms']:.4f}, bound "
          f"{k4_int32['bound_ms']:.4f}; plain {k4['plain_ms']:.4f}; F.conv2d f32 NCHW "
          f"{k4_lib['nchw_f32']:.4f}, f32 channels_last {k4_lib['nhwc_f32']:.4f}, bf16 channels_last "
          f"{k4_lib['nhwc_bf16']:.4f}), mobilenetv2_dynamic {k4_dyn['ms']:.4f} ms (bf16 store, bound "
          f"{k4_dyn['bound_ms']:.4f}, {k4_dyn['bound_ms'] / k4_dyn['ms']:.1%}); "
          f"host cost per call int8_gemm {host['int8_gemm']:.2f} us, fused_dynamic_gemm "
          f"{host['fused_dynamic_gemm']:.2f} us, torch._int_mm {host['torch._int_mm']:.2f} us")
    first = FC_BATCHES[0]
    k2_entry = dict(k2[first], own_ms=k2_own[first], host_us=host["fused_dynamic_gemm"],
                    back_to_back_ms=k2_b2b[first])
    for bt in FC_BATCHES[1:]:
        k2_entry.update({f"bs{bt}_ms": k2[bt]["ms"], f"bs{bt}_own_ms": k2_own[bt],
                         f"bs{bt}_bound_ms": k2[bt]["bound_ms"],
                         f"bs{bt}_plain_ms": k2[bt]["plain_ms"], f"bs{bt}_back_to_back_ms": k2_b2b[bt]})
    k2_entry.update(mobilenetv2_fc_ms=k2_mnv2["ms"], mobilenetv2_fc_bound_ms=k2_mnv2["bound_ms"],
                    mobilenetv2_fc_plain_ms=k2_mnv2["plain_ms"],
                    mobilenetv2_fc_back_to_back_ms=k2_b2b["mobilenetv2_fc"])
    k4_entry = dict(k4, int32_ms=k4_int32["ms"], int32_bound_ms=k4_int32["bound_ms"],
                    back_to_back_ms=k4_lib["events"],
                    library_nhwc_f32_ms=k4_lib["nhwc_f32"], library_nhwc_bf16_ms=k4_lib["nhwc_bf16"],
                    dynamic_ms=k4_dyn["ms"], dynamic_bound_ms=k4_dyn["bound_ms"],
                    dynamic_plain_ms=k4_dyn["plain_ms"])
    return k1_int32, k1, k1g, k2_entry, k3, k4_entry, k1p, plans


def build_models(torch, dev):
    """The paths' models as a user builds them, from seeds: the dynamic-INT8
    convnet (init -> BN fold -> dynamic quantize) with a bs1024 batch; its
    static-INT8 sibling (the same weights, BN fold -> min-max calibration on
    32 images -> bake, fp32 stem) with a bs1024 batch, as
    quantnet_torch.entry.static_entry builds it, and its W4A8 bake from the
    same calibration; the static-INT8 ResNet-50 (init -> BN fold -> min-max
    calibration on 32 images -> bake, fp32 stem) with a bs128 batch at
    224x224, and the same with an int8 stem, 7x7 and space-to-depth; and
    MobileNetV2 at 224x224, bs256, static (int8 stem) and dynamic, as
    quantnet_torch.entry.mobilenet_entry builds it."""
    from quantnet_torch.entry import mobilenet_entry, resnet_entry, static_entry
    from quantnet_torch.models import convnet, mobilenet, resnet
    from quantnet_torch.quantize import dynamic, fold, static
    from quantnet_torch.quantize.common import s4_runtime_tree

    t0 = time.perf_counter()
    params, state = convnet.init(torch.Generator().manual_seed(SEED), device=dev)
    qparams, qstate = dynamic.quantize(params, state)
    x = torch.randn((BATCH, 32, 32, 3), generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    models = {"convnet": dict(apply=convnet.apply, params=params, state=state, q=qparams,
                              qs=qstate, x=x)}
    _, (sq, sqs, sx) = static_entry(dev, batch_size=BATCH, calibration_size=RESNET_CALIBRATION,
                                    seed=SEED)
    models["convnet_static"] = dict(apply=convnet.apply, params=params, state=state, q=sq, qs=sqs, x=sx)
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
    # W4A8: the static sibling's weights and calibration, 4-bit weights, the
    # dense layers grouped (g128) through K1's grouped-K mode.
    cp, cs = models["convnet"]["params"], models["convnet"]["state"]
    fparams, fstate = fold.fold_model(cp, cs)
    calib = torch.randn((RESNET_CALIBRATION, 32, 32, 3),
                        generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    act = static.calibrate(convnet.apply, fparams, fstate, [calib])
    wq, wqs = static.bake(fparams, fstate, act, skip_first_layer=True, weight_bits=4,
                          weight_group_size=W4A8_GROUP)
    models["convnet_w4a8"] = dict(apply=convnet.apply, params=cp, state=cs, q=wq, qs=wqs,
                                  x=models["convnet_static"]["x"])
    # The same W4A8 tree under the s4 runtime: its 4-bit weights nibble-packed,
    # K1 in its packed-B mode (normal at the convs, grouped at fc1 and fc2).
    models["convnet_w4a8_s4"] = dict(models["convnet_w4a8"], q=s4_runtime_tree(wq))
    # MobileNetV2 1.0 at 224x224, bs256: static INT8 (int8 stem) and dynamic.
    t2 = time.perf_counter()
    for name, scheme in (("mobilenetv2", "static"), ("mobilenetv2_dynamic", "dynamic")):
        _, (q, qs, x) = mobilenet_entry(dev, scheme=scheme, batch_size=MNV2_BATCH, image_size=MNV2_IMAGE,
                                        calibration_size=RESNET_CALIBRATION, seed=SEED)
        models[name] = dict(apply=mobilenet.apply, q=q, qs=qs, x=x)
    mp, ms = mobilenet.init(torch.Generator().manual_seed(SEED), device=dev)
    for name in ("mobilenetv2", "mobilenetv2_dynamic"):
        models[name].update(params=mp, state=ms)
    torch.cuda.synchronize()
    models["mobilenetv2"]["set_up_s"] = time.perf_counter() - t2
    # ResNet-50 with the space-to-depth stem, and the 7x7 tree it is held
    # against, both with an int8 stem (K1 at K = 192 and at K = 147 padded).
    for name, s2d in (("resnet50_s2d", True), ("resnet50_7x7_int8", False)):
        _, (q, qs, x) = resnet_entry(dev, batch_size=RESNET_BATCH, image_size=RESNET_IMAGE,
                                     calibration_size=RESNET_CALIBRATION, seed=SEED, s2d=s2d,
                                     skip_first_layer=False)
        models[name] = dict(apply=resnet.apply, q=q, qs=qs, x=x)
    torch.cuda.synchronize()
    phase("models", t0, f"convnet, convnet_static and convnet_w4a8 (int8-wide and s4) bs{BATCH}, resnet50 bs{RESNET_BATCH} "
          f"{RESNET_IMAGE}x{RESNET_IMAGE} (set-up {models['resnet50']['set_up_s']:.2f} s) with the 7x7 "
          f"and the s2d int8 stem, mobilenetv2 static and dynamic bs{MNV2_BATCH} {MNV2_IMAGE}x"
          f"{MNV2_IMAGE} (set-up {models['mobilenetv2']['set_up_s']:.2f} s)")
    return models


def _store_name(epi) -> str:
    if epi is None:
        return "int32"
    parts = [str(epi.out).rsplit(".", 1)[-1]]
    parts += [n for n in ("zpw", "rs", "bias") if getattr(epi, n) is not None]
    if epi.group is not None:
        parts.append(f"grouped g{epi.group}")
    return " ".join(parts + ([epi.act] if epi.act else []))


@contextlib.contextmanager
def held_launches(torch):
    """Inside the scope, every launch of K1 (its grouped-K mode included),
    K2, K3 and K4 held against its plain version on the same inputs, bit for
    bit (compared as integers, so -0 against +0 would count). Yields the
    record: per kernel, the calls by shape with their count and one call's
    inputs (K1: (M, K, N, store) -> [count, a, b, epi]; K4: (shape, stride,
    store) -> [count, x, w, stride, pads, pad_value, epi]; K3: (shape,
    dtype) -> [count, *args]; K2: (M, K, N, x dtype) -> [count, *args]), and
    the largest |kernel - plain|."""
    from quantnet_torch.models import resnet as resnet_mod
    from quantnet_torch.ops import conv as ops_conv
    from quantnet_torch.ops import linear as ops_linear
    from quantnet_torch.ops.depthwise_conv import depthwise_conv, depthwise_conv_plain
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm, fused_dynamic_gemm_plain
    from quantnet_torch.ops.int8_matmul import int8_gemm_epilogue, int8_gemm_epilogue_plain
    from quantnet_torch.ops.residual_boundary import residual_boundary, residual_boundary_plain

    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.int8: torch.int8,
            torch.int32: torch.int32}
    names = ("int8_gemm", "fused_dynamic_gemm", "depthwise_conv", "residual_boundary")
    rec = {"calls": {n: {} for n in names}, "err": {n: 0.0 for n in names}}

    def held(name, key, got, ref, args):
        bad = int((got.contiguous().view(bits[got.dtype]) != ref.contiguous().view(bits[ref.dtype])).sum())
        check(got.dtype == ref.dtype and bad == 0,
              f"{name} {key}: {bad} of {ref.numel()} differ from the plain version")
        rec["calls"][name].setdefault(key, [0, *args])[0] += 1
        rec["err"][name] = max(rec["err"][name], (got.float() - ref.float()).abs().max().item())
        return got

    def k1(a, b, epi):
        return held("int8_gemm", (a.shape[0], a.shape[1], b.shape[0], _store_name(epi)),
                    int8_gemm_epilogue(a, b, epi), int8_gemm_epilogue_plain(a, b, epi), (a, b, epi))

    def k4(x, w, stride, pads, pad_value, epi):
        args = (x, w, stride, pads, pad_value, epi)
        return held("depthwise_conv", (tuple(x.shape), stride, _store_name(epi)),
                    depthwise_conv(*args), depthwise_conv_plain(*args), args)

    def k3(*args):
        return held("residual_boundary", (tuple(args[0].shape), str(args[1].dtype)),
                    residual_boundary(*args), residual_boundary_plain(*args), args)

    def k2(*args):
        x, w_nk = args[0], args[1]
        return held("fused_dynamic_gemm", (x.shape[0], x.shape[1], w_nk.shape[0], str(x.dtype)),
                    fused_dynamic_gemm(*args), fused_dynamic_gemm_plain(*args), args)

    ops_linear.int8_gemm_epilogue, ops_linear.fused_dynamic_gemm = k1, k2
    ops_conv.depthwise_conv, resnet_mod.residual_boundary = k4, k3
    try:
        yield rec
        torch.cuda.synchronize()
    finally:
        ops_linear.int8_gemm_epilogue = int8_gemm_epilogue
        ops_conv.depthwise_conv = depthwise_conv
        resnet_mod.residual_boundary = residual_boundary
        ops_linear.fused_dynamic_gemm = fused_dynamic_gemm


def held_counts(rec) -> dict:
    """A held_launches record's launches by kernel, counted as the wrappers
    count them: every launch, and K1's grouped-K ones apart."""
    calls = rec["calls"]
    counts = {name: sum(c[0] for c in v.values()) for name, v in calls.items()}
    counts["int8_gemm_grouped"] = sum(c[0] for c in calls["int8_gemm"].values() if getattr(c[3], "group", None) is not None)
    return counts


def k1_stores_phase(torch, models):
    """One forward of each model with every K1, K2, K3 and K4 launch held
    against its plain version (held_launches). Returns, per path, the K1
    calls by (M, K, N, store) with their count and one call's inputs, and
    MobileNetV2's K4 calls the same way, for [times]; and the largest
    |kernel - plain| of K1 and K4."""
    t0 = time.perf_counter()
    found, dw_found, errors, k3, k2 = {}, {}, {}, 0, 0
    for path, m in models.items():
        with held_launches(torch) as rec:
            m["apply"](m["q"], m["qs"], m["x"])
        found[path] = rec["calls"]["int8_gemm"]
        if rec["calls"]["depthwise_conv"]:
            dw_found[path] = rec["calls"]["depthwise_conv"]
        errors[path] = {"k1": rec["err"]["int8_gemm"], "k4": rec["err"]["depthwise_conv"]}
        k3 += held_counts(rec)["residual_boundary"]
        k2 += held_counts(rec)["fused_dynamic_gemm"]
    per_path = "; ".join(
        f"{p} {sum(c[0] for c in v.values())} launches at {len(v)} shapes "
        f"({', '.join(sorted({k[3] for k in v}))})" for p, v in found.items())
    dw = "; ".join(f"{p} {sum(c[0] for c in v.values())} launches "
                   f"({', '.join(sorted({k[2] for k in v}))})" for p, v in dw_found.items())
    phase("k1 stores", t0, f"every K1 launch of a forward bit-equal to int8_gemm_epilogue_plain: "
          f"{per_path}; every K4 launch bit-equal to depthwise_conv_plain: {dw}; every K3 launch "
          f"bit-equal to residual_boundary_plain: {k3}; every K2 launch bit-equal to "
          f"fused_dynamic_gemm_plain: {k2}")
    return found, dw_found, errors


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
    stats = m["bench_stats"] = bench.measure(resnet.apply, qparams, qstate, RESNET_BATCH)
    phase("resnet50 bench", t1, f"bs{RESNET_BATCH} {RESNET_IMAGE}x{RESNET_IMAGE}: p50 "
          f"{stats['p50_ms']:.4f} ms, {stats['images_per_s_p50']:.1f} img/s (mean "
          f"{stats['mean_ms']:.4f} ms, min {stats['min_ms']:.4f}, max {stats['max_ms']:.4f}, "
          f"{stats['iters']} iters) on {stats['device']}")
    return launches


def _roofline(stats) -> str:
    mfu = stats.get("mfu")
    return (f"{stats['model_gops']:.4f} GOP, {stats['achieved_tops']:.4f} TOP/s, mfu "
            f"{'n/a' if mfu is None else format(mfu, '.6f')}")


def static_phase(torch, dev, m):
    """The convnet's static-INT8 sibling at bs1024: every layer after the
    fp32 stem hands int8 to the next in its frozen domain, seven K1 launches
    (conv2-conv6 and fc1 storing int8, fc2 storing f32)."""
    from quantnet_torch.bench.benchmark import InferenceBenchmark
    from quantnet_torch.core.config import Flags
    from quantnet_torch.models import convnet
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.ops.residual_boundary import residual_boundary
    from quantnet_torch.quantize import fold

    t0 = time.perf_counter()
    params, state, qparams, qstate, x = m["params"], m["state"], m["q"], m["qs"], m["x"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    int8_gemm.launches = residual_boundary.launches = fused_dynamic_gemm.launches = 0
    logits, _ = convnet.apply(qparams, qstate, x)
    torch.cuda.synchronize()
    launches = {"int8_gemm": int8_gemm.launches, "fused_dynamic_gemm": fused_dynamic_gemm.launches,
                "residual_boundary": residual_boundary.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    check(tuple(logits.shape) == (BATCH, 10), f"logits shape {tuple(logits.shape)}")
    check(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(launches == {"int8_gemm": 7, "fused_dynamic_gemm": 0, "residual_boundary": 0},
          f"launches per forward {launches}, expected 7 int8_gemm and nothing else")
    ref, _ = convnet.apply(qparams, qstate, x, flags=Flags(plain=True))
    scale = ref.abs().max().item()
    err = (logits - ref).abs().max().item()
    check(torch.equal(logits.view(torch.int32), ref.view(torch.int32)),
          f"static convnet vs plain versions: max |diff| {err} (max|logit| {scale}), not bit-equal")
    fparams, fstate = fold.fold_model(params, state)
    fp32, _ = convnet.apply(fparams, fstate, x)
    rel = ((logits - fp32).norm() / fp32.norm()).item()
    agree = (logits.argmax(1) == fp32.argmax(1)).float().mean().item()
    check(rel < STATIC_FP32_REL_L2_MAX,
          f"static INT8 convnet vs fp32 logits: relative L2 {rel} >= {STATIC_FP32_REL_L2_MAX}")
    phase("static", t0, f"logits {tuple(logits.shape)} finite; launches {launches}; max |kernels - "
          f"plain| {err!r} (max|logit| {scale:.4f}, bit-equal); vs fp32: rel L2 {rel:.4f}, top-1 "
          f"agreement {agree:.4f}; peak {peak_gib:.2f} GiB")

    t1 = time.perf_counter()
    stats = InferenceBenchmark(warmup=10, iters=50).measure(convnet.apply, qparams, qstate, BATCH)
    phase("static bench", t1, f"bs{BATCH}: p50 {stats['p50_ms']:.4f} ms, "
          f"{stats['images_per_s_p50']:.1f} img/s (mean {stats['mean_ms']:.4f} ms, min "
          f"{stats['min_ms']:.4f}, max {stats['max_ms']:.4f}, {stats['iters']} iters); "
          f"{_roofline(stats)} on {stats['device']}")
    return launches


def _launch_counts():
    """Every wrapper's launch count, by name (K1's grouped-K mode apart)."""
    from quantnet_torch.ops.depthwise_conv import depthwise_conv
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.ops.residual_boundary import residual_boundary

    return {"int8_gemm": int8_gemm.launches, "int8_gemm_grouped": int8_gemm.grouped_launches,
            "fused_dynamic_gemm": fused_dynamic_gemm.launches,
            "residual_boundary": residual_boundary.launches,
            "depthwise_conv": depthwise_conv.launches}


def _zero_launch_counts():
    from quantnet_torch.ops.depthwise_conv import depthwise_conv
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.ops.residual_boundary import residual_boundary

    int8_gemm.launches = int8_gemm.grouped_launches = 0
    fused_dynamic_gemm.launches = residual_boundary.launches = depthwise_conv.launches = 0


def _path_run(torch, name, m, want, fp32_rel_max, classes):
    """One forward of a path with every count set to 0 just before it: the
    launches (held to `want`), finite logits of the expected shape,
    bit-equal to the plain-version forward, within `fp32_rel_max` relative
    L2 of the fp32 folded model's. Returns (logits, launches, message)."""
    from quantnet_torch.core.config import Flags
    from quantnet_torch.quantize import fold

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    logits, _ = m["apply"](m["q"], m["qs"], m["x"])
    torch.cuda.synchronize()
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    batch = m["x"].shape[0]
    check(tuple(logits.shape) == (batch, classes) and logits.dtype == torch.float32,
          f"[{name}] logits {logits.dtype}{tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"[{name}] non-finite logits")
    check(launches == want, f"[{name}] launches per forward {launches}, expected {want}")
    ref, _ = m["apply"](m["q"], m["qs"], m["x"], flags=Flags(plain=True))
    err = (logits - ref).abs().max().item()
    check(torch.equal(logits.view(torch.int32), ref.view(torch.int32)),
          f"[{name}] vs plain versions: max |diff| {err} (max|logit| {ref.abs().max().item()}), "
          "not bit-equal")
    fparams, fstate = fold.fold_model(m["params"], m["state"])
    fp32, _ = m["apply"](fparams, fstate, m["x"])
    rel = ((logits - fp32).norm() / fp32.norm()).item()
    agree = (logits.argmax(1) == fp32.argmax(1)).float().mean().item()
    check(rel < fp32_rel_max, f"[{name}] vs fp32 logits: relative L2 {rel} >= {fp32_rel_max}")
    msg = (f"logits {tuple(logits.shape)} finite; launches {launches}; bit-equal to the plain "
           f"versions (max|logit| {ref.abs().max().item():.4f}); vs fp32: rel L2 {rel:.4f} (bound "
           f"{fp32_rel_max}), top-1 agreement {agree:.4f}; peak {peak_gib:.2f} GiB")
    return logits, launches, msg


def _bench_line(torch, m, image, batch, warmup=5, iters=30) -> str:
    from quantnet_torch.bench.benchmark import InferenceBenchmark

    stats = InferenceBenchmark(image_size=image, warmup=warmup, iters=iters).measure(
        m["apply"], m["q"], m["qs"], batch)
    return (f"bs{batch} {image}x{image}: p50 {stats['p50_ms']:.4f} ms, {stats['images_per_s_p50']:.1f} "
            f"img/s (mean {stats['mean_ms']:.4f} ms, min {stats['min_ms']:.4f}, max "
            f"{stats['max_ms']:.4f}, {stats['iters']} iters); {_roofline(stats)} on {stats['device']}")


def w4a8_phase(torch, m):
    """The W4A8 convnet at bs1024: the static sibling's int8 handoffs, 4-bit
    weights, fc1 and fc2 through K1's grouped-K mode (g128)."""
    t0 = time.perf_counter()
    want = {"int8_gemm": 7, "int8_gemm_grouped": 2, "fused_dynamic_gemm": 0,
            "residual_boundary": 0, "depthwise_conv": 0}
    _, launches, msg = _path_run(torch, "w4a8", m, want, W4A8_FP32_REL_L2_MAX, 10)
    phase("w4a8", t0, msg)
    t1 = time.perf_counter()
    phase("w4a8 bench", t1, _bench_line(torch, m, 32, BATCH, warmup=10, iters=50))
    return launches


def mobilenet_phase(torch, models):
    """MobileNetV2 1.0 at 224x224, bs256: static INT8 (int8 stem; K1 at the
    stem, the 16 expand, 17 project and head convs and the fc, K4 at the 17
    depthwise convs) and dynamic INT8 (the same, the fc through K2)."""
    out = {}
    for name, scheme, want in (
            ("mobilenetv2", "static", {"int8_gemm": 36, "int8_gemm_grouped": 0, "fused_dynamic_gemm": 0,
                                       "residual_boundary": 0, "depthwise_conv": 17}),
            ("mobilenetv2_dynamic", "dynamic", {"int8_gemm": 35, "int8_gemm_grouped": 0,
                                                "fused_dynamic_gemm": 1, "residual_boundary": 0,
                                                "depthwise_conv": 17})):
        t0 = time.perf_counter()
        m = models[name]
        _, launches, msg = _path_run(torch, name, m, want, MNV2_FP32_REL_L2_MAX, 1000)
        phase(name, t0, f"{scheme}: {msg}")
        t1 = time.perf_counter()
        phase(f"{name} bench", t1, _bench_line(torch, m, MNV2_IMAGE, MNV2_BATCH))
        out[name] = launches
    return out


def s2d_phase(torch, models):
    """Static ResNet-50 with the space-to-depth stem (int8 stem, K1 at K =
    192) at bs128, bit-equal to its plain run, and against the 7x7 tree with
    an int8 stem calibrated on the same images."""
    t0 = time.perf_counter()
    m, ref = models["resnet50_s2d"], models["resnet50_7x7_int8"]
    check(tuple(m["q"]["conv1"]["w"].shape) == (4, 4, 12, 64), "[resnet50 s2d] the stem is not folded")
    want = {"int8_gemm": 54, "int8_gemm_grouped": 0, "fused_dynamic_gemm": 0, "residual_boundary": 15,
            "depthwise_conv": 0}
    from quantnet_torch.core.config import Flags

    _zero_launch_counts()
    logits, _ = m["apply"](m["q"], m["qs"], m["x"])
    torch.cuda.synchronize()
    launches = _launch_counts()
    check(launches == want, f"[resnet50 s2d] launches per forward {launches}, expected {want}")
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (RESNET_BATCH, 1000),
          "[resnet50 s2d] logits")
    plain, _ = m["apply"](m["q"], m["qs"], m["x"], flags=Flags(plain=True))
    check(torch.equal(logits, plain), f"[resnet50 s2d] vs plain versions: max |diff| "
          f"{(logits - plain).abs().max().item()}, not bit-equal")
    other, _ = ref["apply"](ref["q"], ref["qs"], ref["x"])
    diff = (logits - other).abs().max().item() / other.abs().max().item()
    rel = ((logits - other).norm() / other.norm()).item()
    agree = (logits.argmax(1) == other.argmax(1)).float().mean().item()
    check(diff < S2D_MAX_DIFF and rel < S2D_REL_L2_MAX,
          f"[resnet50 s2d] vs the 7x7 int8-stem tree: max |diff| {diff} x max|logit| (bound "
          f"{S2D_MAX_DIFF}), rel L2 {rel} (bound {S2D_REL_L2_MAX})")
    phase("resnet50 s2d", t0, f"logits {tuple(logits.shape)} finite; launches {launches}; bit-equal "
          f"to the plain versions; vs the 7x7 int8-stem tree: max |diff| {diff:.6f} x max|logit|, "
          f"rel L2 {rel:.6f}, top-1 agreement {agree:.4f}")
    t1 = time.perf_counter()
    phase("resnet50 s2d bench", t1, _bench_line(torch, m, RESNET_IMAGE, RESNET_BATCH))
    phase("resnet50 7x7 int8 stem bench", time.perf_counter(),
          _bench_line(torch, ref, RESNET_IMAGE, RESNET_BATCH))
    return launches


def _host_counts(logits: list, labels, top_k: int = 5):
    """Top-1 and top-k hits counted on the host from the logits' bits."""
    import numpy as np

    lg = np.concatenate([t.float().cpu().numpy() for t in logits])
    top1 = int((lg.argmax(1) == labels).sum())
    order = np.argsort(-lg, axis=1, kind="stable")[:, :top_k]
    topk = int((order == labels[:, None]).any(1).sum())
    return lg.argmax(1), top1, topk


def schemes_phase(torch, dev, models):
    """The convnet's scheme matrix from the same seeded weights: artifacts
    round-tripped, scored by the evaluator, held against fp32, benched."""
    import pathlib
    import tempfile

    from quantnet_torch.bench.benchmark import InferenceBenchmark
    from quantnet_torch.data.datasets import load_cifar10
    from quantnet_torch.evaluation.evaluator import compare_models
    from quantnet_torch.models import convnet
    from quantnet_torch.quantize import bf16, weight_only
    from quantnet_torch.train.checkpoint import load_artifact, save_artifact

    t0 = time.perf_counter()
    params, state = models["convnet"]["params"], models["convnet"]["state"]
    trees = {
        "fp32": (params, state),
        "dynamic": (models["convnet"]["q"], models["convnet"]["qs"]),
        "static": (models["convnet_static"]["q"], models["convnet_static"]["qs"]),
        "weight_only": weight_only.quantize(params, state),
        "weight_only_int4": weight_only.quantize(params, state, bits=4, group_size=128),
        "bf16": bf16.quantize(params, state),
        "w4a8": (models["convnet_w4a8"]["q"], models["convnet_w4a8"]["qs"]),
    }
    x = models["convnet"]["x"][:256]
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    loaded = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for name, (q, qs) in trees.items():
            before, _ = convnet.apply(q, qs, x)
            path = str(pathlib.Path(tmp) / name)
            save_artifact(path, {"params": q, "state": qs}, {"model": "simple_convnet", "scheme": name})
            tree, meta = load_artifact(path, device=dev)
            after, _ = convnet.apply(tree["params"], tree["state"], x)
            check(meta["scheme"] == name and torch.equal(before.view(torch.int32), after.view(torch.int32)),
                  f"{name}: logits after the artifact round trip differ, max |diff| "
                  f"{(before - after).abs().max().item()!r}")
            loaded[name] = (tree["params"], tree["state"])
    phase("artifacts", t0, f"{len(loaded)} schemes saved and loaded, logits bit-equal after the round trip")

    t1 = time.perf_counter()
    _, test = load_cifar10("./data", synthetic_train_size=1)
    scores = compare_models({n: (convnet.apply, q, qs) for n, (q, qs) in loaded.items()}, test,
                            batch_size=512, device=dev)
    preds = {}
    for name, (q, qs) in loaded.items():
        logits = [convnet.apply(q, qs, torch.from_numpy(test.images[i:i + 512]).to(dev))[0]
                  for i in range(0, len(test), 512)]
        preds[name], top1, top5 = _host_counts(logits, test.labels)
        r = scores[name]
        check(r["n"] == len(test) and r["top1"] == top1 / len(test) and r["top5"] == top5 / len(test),
              f"{name}: evaluator top-1 {r['top1']} / top-5 {r['top5']} over {r['n']}, the host counts "
              f"{top1} / {top5} of {len(test)}")
    agreement = {n: float((p == preds["fp32"]).mean()) for n, p in preds.items()}
    for name, low in SCHEME_AGREEMENT_MIN.items():
        check(agreement[name] >= low, f"{name}: predictions agree with fp32 on {agreement[name]:.4f} "
              f"of the split, below {low}")
    phase("evaluator", t1, f"{test.name} ({len(test)} images): evaluator counts equal the host's for "
          f"every scheme; agreement with fp32 {', '.join(f'{n} {a:.4f}' for n, a in agreement.items())}")

    t2 = time.perf_counter()
    bench = InferenceBenchmark(warmup=5, iters=30)
    for name, (q, qs) in loaded.items():
        torch.cuda.reset_peak_memory_stats()
        res = bench.compare_models({name: (convnet.apply, q, qs)}, batch_sizes=SCHEME_BATCHES)[name]
        r = scores[name]
        b1, b32 = res["bs1"], res["bs32"]
        print(f"  scheme {name}: top-1 {r['top1']:.4f}, top-5 {r['top5']:.4f}, agreement with fp32 "
              f"{agreement[name]:.4f}; size {res['model_size_mb']:.4f} MB; bs1 p50 {b1['p50_ms']:.4f} ms, "
              f"bs32 p50 {b32['p50_ms']:.4f} ms ({b32['images_per_s_p50']:.1f} img/s), mfu bs32 "
              f"{b32.get('mfu', float('nan')):.6f}; peak {res['device_memory']['peak_mb_in_use']:.1f} MB "
              f"in use", flush=True)
    phase("schemes", t2, f"{len(loaded)} schemes benched at bs{' and bs'.join(map(str, SCHEME_BATCHES))}")


def _served(eng, images, trickle: bool):
    """Submit `images` (trickle: one at a time, each awaited; else all at
    once) -> (logits, seconds, latency stats, engine stats, occupancy)."""
    eng.reset_stats()
    t0 = time.perf_counter()
    if trickle:
        out = [eng.predict(img, timeout=120) for img in images]
    else:
        futs = [eng.submit(img) for img in images]
        out = [f.result(timeout=120) for f in futs]
    seconds = time.perf_counter() - t0
    return out, seconds, eng.latency_stats(), dict(eng.stats), eng.occupancy()


def _serve_loads(eng, loads, wait_ms):
    """Each load in turn (trickle ones with the coalescing window or without
    it, then the burst) -> {kind: _served(...)}."""
    runs = {}
    for kind, imgs in loads:
        eng.max_wait_s = 0.0 if kind == "trickle, no window" else wait_ms / 1e3
        runs[kind] = _served(eng, imgs, kind.startswith("trickle"))
    return runs


def _load_line(kind, n, seconds, lat, stats, occ) -> str:
    return (f"{kind} {n}: {n / seconds:.1f} req/s, p50 {lat['p50_ms']:.4f} / p95 {lat['p95_ms']:.4f} "
            f"/ p99 {lat['p99_ms']:.4f} ms, {int(stats['batches'])} batches, occupancy {occ:.4f}")


TRACE_TRIES = 3


def _traced(fn, verify, retraced: list, label: str):
    """bench/trace.py's trace of fn(i), the i-th try, taken again (up to
    TRACE_TRIES times in all) where the profiler recorded none of the port's
    kernels. Each try runs on inputs that differ from the ones its graphs
    ran before, and verify(i, out) holds that try's own output against an
    eager reference first, raising where it differs: a graph that launched
    nothing would leave the earlier result in its output buffer and fail
    there. So a retake follows only a run whose kernels demonstrably ran,
    and blames the instrument (on an H100 CUPTI has dropped 10 of a replay's
    53 records, every record of one replay, and every kernel record of one
    whose other device rows it kept). Each retaken trace's device rows are
    printed. Appends the retakes to `retraced`; returns (fn's result, the
    profile)."""
    from quantnet_torch.bench.trace import device_rows, kernel_launches, trace

    for i in range(TRACE_TRIES):
        out, prof = trace(lambda: fn(i))
        verify(i, out)
        if any(kernel_launches(prof).values()) or i == TRACE_TRIES - 1:
            retraced.append(i)
            return out, prof
        rows = [(e.key, e.count) for e in device_rows(prof)]
        print(f"  {label}: trace {i + 1} of {TRACE_TRIES} recorded none of the port's kernels, "
              f"its output right; the device rows it kept: {rows}", flush=True)


def serve_phase(torch, dev, models):
    """Each path served by the continuous-batching engine through its CUDA
    graphs: every bucket's replay bit-equal to an eager forward of the same
    batch and launching, in a device trace, the kernels the wrappers count
    in that eager forward; trickle and burst loads, during which no wrapper
    is called (every batch a replay); the same loads under a device trace,
    its kernel launches equal to one replay's times the batches served;
    every served request's logits against an eager forward of the same
    images at the largest bucket."""
    import numpy as np

    from quantnet_torch.bench.trace import kernel_launches
    from quantnet_torch.ops.depthwise_conv import depthwise_conv
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.ops.residual_boundary import residual_boundary
    from quantnet_torch.serve import InferenceEngine

    wrappers = (int8_gemm, fused_dynamic_gemm, residual_boundary, depthwise_conv)
    retraced = []

    def counted(fn):
        """The wrappers' launch counts over fn(), from 0."""
        for k in wrappers:
            k.launches = 0
        fn()
        torch.cuda.synchronize()
        return {k.__name__: k.launches for k in wrappers}

    out = {}
    for path, image, burst, buckets, wait_ms, trickle, norm in SERVED:
        t0 = time.perf_counter()
        m = models[path]
        shape = (image, image, 3)
        with InferenceEngine(m["apply"], m["q"], m["qs"], image_shape=shape, buckets=buckets,
                             max_wait_ms=wait_ms, device=dev, wire_dtype="uint8",
                             normalize=norm) as eng:
            capture_s = time.perf_counter() - t0
            g = torch.Generator().manual_seed(SEED + 3)
            for b in eng.buckets:
                x, *fresh = (torch.randint(0, 256, (b, *shape), generator=g, dtype=torch.uint8).to(dev)
                             for _ in range(1 + TRACE_TRIES))
                got, want = eng.replay(x), eng.forward(x)
                err = (got - want).abs().max().item()
                check(torch.equal(got, want), f"[serve] {path} bucket {b}: replay vs eager forward "
                      f"max |diff| {err}, not bit-equal")
                eager = counted(lambda: eng.forward(x))

                def same(i, out, b=b, fresh=fresh):
                    check(torch.equal(out, eng.forward(fresh[i])), f"[serve] {path} bucket {b}: the "
                          f"traced replay (try {i + 1}) vs eager forward of its own input, not bit-equal")

                _, prof = _traced(lambda i: eng.replay(fresh[i]), same, retraced, f"[serve] {path} bucket {b}")
                per_replay = kernel_launches(prof)
                check(per_replay == eager and any(eager.values()),
                      f"[serve] {path} bucket {b}: one replay launched {per_replay} in its trace, "
                      f"the eager forward {eager}")
            per_forward = per_replay  # the largest bucket's
            rng = np.random.default_rng(SEED + 4)
            loads = [("burst", rng.integers(0, 256, (burst, *shape), dtype=np.uint8))]
            if trickle:
                for kind in ("trickle", "trickle, no window"):
                    loads.insert(-1, (kind, rng.integers(0, 256, (TRICKLE_REQUESTS, *shape),
                                                         dtype=np.uint8)))
            runs = {}
            called = counted(lambda: runs.update(_serve_loads(eng, loads, wait_ms)))
            check(not any(called.values()), f"[serve] {path}: the wrappers launched {called} during "
                  "the loads: a batch ran outside its graph")
            # The same loads again under a device trace, for the launches;
            # each batch's images differ from the last batch's in its bucket.

            def same_loads(i, traced):
                for kind, _ in loads:
                    check(np.array_equal(np.stack(runs[kind][0]), np.stack(traced[kind][0])),
                          f"[serve] {path} {kind}: the traced run's logits (try {i + 1}) differ from "
                          "the untraced run's")

            traced_runs, prof = _traced(lambda i: _serve_loads(eng, loads, wait_ms), same_loads, retraced,
                                        f"[serve] {path} loads")
            launches = kernel_launches(prof)
            batches = sum(r[3]["batches"] for r in traced_runs.values())
            want = {k: n * batches for k, n in per_forward.items()}
            check(launches == want, f"[serve] {path}: traced launches {launches} in {batches} "
                  f"batches, expected {want} ({per_forward} a replay)")
            lines = []
            for kind, imgs in loads:
                served = np.stack(runs[kind][0])
                ref = []
                for i in range(0, len(imgs), buckets[-1]):
                    chunk = np.zeros((buckets[-1], *shape), np.uint8)
                    chunk[: len(imgs[i:i + buckets[-1]])] = imgs[i:i + buckets[-1]]
                    ref.append(eng.forward(torch.from_numpy(chunk).to(dev))[: len(imgs[i:i + buckets[-1]])])
                ref = torch.cat(ref).cpu().numpy()
                delta = float(np.abs(served - ref).max())
                rel = float(np.linalg.norm(served - ref) / np.linalg.norm(ref))
                same = bool(np.array_equal(served, ref))
                check(bool(np.isfinite(served).all()), f"[serve] {path} {kind}: non-finite logits")
                check(np.array_equal(served.argmax(1), ref.argmax(1)),
                      f"[serve] {path} {kind}: argmax differs from the eager forward")
                check(rel < SERVE_REL_L2_MAX, f"[serve] {path} {kind}: rel L2 {rel} >= {SERVE_REL_L2_MAX}")
                check(same, f"[serve] {path} {kind}: max |diff| {delta}, not bit-equal")
                lines.append(f"{_load_line(kind, len(imgs), *runs[kind][1:])}; vs eager max |diff| "
                             f"{delta!r}, rel L2 {rel:.3e}{', bit-equal' if same else ''}")
                out.setdefault(path, {})[kind] = dict(
                    requests=len(imgs), seconds=runs[kind][1], req_per_s=len(imgs) / runs[kind][1],
                    occupancy=runs[kind][4], batches=runs[kind][3]["batches"], **runs[kind][2])
            out[path]["launches_per_forward"] = per_forward
            out[path]["launches"] = launches
        phase("serve", t0, f"{path} {image}x{image} u8 wire, buckets {buckets}: captured in "
              f"{capture_s:.2f} s, every bucket's replay bit-equal to the eager forward and "
              f"launching its kernels in a trace; no wrapper called during the loads; traced loads "
              f"launched {launches} in {batches} batches ({per_forward} a replay); traces retaken "
              f"for no kernel record so far: {sum(retraced)}; " + "; ".join(lines))
    return out


def observers_phase(torch, dev, m):
    """Static ResNet-50 calibrated with the histogram and the MSE observer
    (one batch of 32 images, as the resnet50 path's min-max), each forward
    at bs128 finite, its relative L2 to fp32 printed."""
    from quantnet_torch.models import resnet
    from quantnet_torch.quantize import fold, static

    t0 = time.perf_counter()
    params, state, x = m["params"], m["state"], m["x"]
    shape = (RESNET_CALIBRATION, RESNET_IMAGE, RESNET_IMAGE, 3)
    calib = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    fparams, fstate = fold.fold_model(params, state)
    fp32, _ = resnet.apply(fparams, fstate, x)
    parts = []
    for kind in ("histogram", "mse"):
        q, qs = static.quantize(params, state, resnet.apply, [calib], skip_first_layer=True,
                                observer=kind)
        logits, _ = resnet.apply(q, qs, x)
        check(tuple(logits.shape) == (RESNET_BATCH, 1000) and bool(torch.isfinite(logits).all()),
              f"[observers] {kind}: logits {tuple(logits.shape)} not finite")
        rel = ((logits - fp32).norm() / fp32.norm()).item()
        agree = (logits.argmax(1) == fp32.argmax(1)).float().mean().item()
        parts.append(f"{kind}: rel L2 to fp32 {rel:.4f}, top-1 agreement {agree:.4f}")
    phase("observers", t0, f"static ResNet-50 bs{RESNET_BATCH}, finite logits; " + "; ".join(parts))


def _top(damage: dict, n: int = 3) -> str:
    return ", ".join(f"{p} {d:.6g}" for p, d in sorted(damage.items(), key=lambda kv: -kv[1])[:n])


def accuracy_phase(torch, dev, models):
    """The accuracy tools at full width, each path driven with every count
    set to 0 just before it and read just after.
    MobileNetV2 1.0, 224x224: quantize_optimized (the sensitivity sweep on
    one probe batch of ACCURACY_BATCH: 53 gated forwards, the quantized
    lanes through K1's f32 store, K4 and K2), its damage map bit-equal to
    the same sweep on the plain versions, the same table, and the optimized
    tree's logits bit-equal to its plain run.
    ResNet-50, 224x224: cross-layer equalization (logits within
    EQUALIZE_REL_L2_MAX of the unequalized fold's); int4_guard on two
    batches (the guard set equal to the plain run's); the W4A8 bake from
    those 32 images, AdaRound (ADAROUND_STEPS steps, max_examples 32) and
    bias correction: every value within 1 LSB of nearest rounding, the hard
    rounding's reconstruction loss below nearest rounding's, and the refined
    and corrected tree's forward at bs128 (K1, its grouped-K mode at the fc,
    K3) bit-equal to its plain run. Returns the launches of each run."""
    from quantnet_torch.core.config import Flags
    from quantnet_torch.models import mobilenet, resnet
    from quantnet_torch.quantize import adaround, fold, policy, static
    from quantnet_torch.quantize.bias_correct import bias_correct
    from quantnet_torch.quantize.equalize import cross_layer_equalize

    plain = Flags(plain=True)
    gen = torch.Generator().manual_seed(SEED + 3)
    shape = (ACCURACY_BATCH, MNV2_IMAGE, MNV2_IMAGE, 3)
    batches = [torch.randn(shape, generator=gen).to(dev) for _ in range(2)]
    out = {}

    t0 = time.perf_counter()
    mp, ms = models["mobilenetv2"]["params"], models["mobilenetv2"]["state"]
    torch.cuda.synchronize()
    _zero_launch_counts()
    t1 = time.perf_counter()
    q, qs, table = policy.quantize_optimized(mp, ms, mobilenet.apply, batches[:1])
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t1
    out["sweep"] = launches = _launch_counts()
    want = {"int8_gemm": 35, "int8_gemm_grouped": 0, "fused_dynamic_gemm": 1,
            "residual_boundary": 0, "depthwise_conv": 17}
    check(launches == want, f"[accuracy] sweep launches {launches}, expected {want}")
    damage = policy.measure_sensitivity(mobilenet.apply, mp, ms, batches[:1])
    damage_plain = policy.measure_sensitivity(functools.partial(mobilenet.apply, flags=plain),
                                              mp, ms, batches[:1])
    check(len(damage) == 53 and all(math.isfinite(d) for d in damage.values()),
          f"[accuracy] damage map: {len(damage)} layers")
    diff = [p for p in damage if damage[p] != damage_plain[p]]
    check(not diff, f"[accuracy] damage not bit-equal to the plain sweep at {diff[:5]}")
    check(policy.build_policy(damage) == table == policy.build_policy(damage_plain),
          "[accuracy] the optimized table differs from the plain sweep's")
    x = batches[1]
    logits, _ = mobilenet.apply(q, qs, x)
    ref, _ = mobilenet.apply(q, qs, x, flags=plain)
    check(bool(torch.isfinite(logits).all()) and torch.equal(logits.view(torch.int32),
                                                              ref.view(torch.int32)),
          "[accuracy] the optimized tree's logits are not bit-equal to its plain run")
    kept = sorted(p for p, v in table.items() if v == "bf16")
    phase("accuracy mobilenetv2", t0, f"quantize_optimized, sensitivity on 1 batch of "
          f"{ACCURACY_BATCH} at {MNV2_IMAGE}x{MNV2_IMAGE}: sweep {sweep_s:.3f} s (53 gated "
          f"forwards), launches {launches}; damage bit-equal to the plain sweep, most sensitive: "
          f"{_top(damage)}; {len(kept)} layers kept bf16; optimized logits bit-equal to plain")

    t0 = time.perf_counter()
    m = models["resnet50"]
    params, state = m["params"], m["state"]
    calib = [torch.randn((ACCURACY_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3), generator=gen).to(dev)
             for _ in range(2)]
    fparams, fstate = fold.fold_model(params, state)
    t1 = time.perf_counter()
    ep, es = cross_layer_equalize(params, state)
    torch.cuda.synchronize()
    equalize_s = time.perf_counter() - t1
    fp32, _ = resnet.apply(fparams, fstate, calib[0])
    eq, _ = resnet.apply(ep, es, calib[0])
    eq_rel = ((eq - fp32).norm() / fp32.norm()).item()
    check(eq_rel < EQUALIZE_REL_L2_MAX, f"[accuracy] equalized logits: rel L2 {eq_rel}")
    t1 = time.perf_counter()
    guard = policy.int4_guard(resnet.apply, params, state, calib)
    torch.cuda.synchronize()
    guard_s = time.perf_counter() - t1
    guard_plain = policy.int4_guard(functools.partial(resnet.apply, flags=plain), params, state,
                                    calib)
    check(guard == guard_plain, f"[accuracy] guard {sorted(guard)} != plain {sorted(guard_plain)}")
    act = static.calibrate(resnet.apply, fparams, fstate, calib)
    nq, nqs = static.bake(fparams, fstate, act, skip_first_layer=True, weight_bits=4,
                          weight_group_size=W4A8_GROUP)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rq, rqs = adaround.refine(nq, nqs, params, state, resnet.apply, calib, steps=ADAROUND_STEPS,
                              max_examples=ADAROUND_EXAMPLES)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    cq, cqs = bias_correct(rq, rqs, params, state, resnet.apply, calib,
                           max_examples=ADAROUND_EXAMPLES)
    torch.cuda.synchronize()
    correct_s = time.perf_counter() - t1
    moved = total = 0
    for path in adaround._refinable_paths(nq):
        node_n, node_r = nq, rq
        for k in path.split("/"):
            node_n, node_r = node_n[k], node_r[k]
        a, b = node_r["w"].values.int(), node_n["w"].values.int()
        check((a - b).abs().max().item() <= 1 and a.abs().max().item() <= 7,
              f"[accuracy] {path}: a refined value moved more than 1 LSB or left [-7, 7]")
        moved += int((a != b).sum())
        total += a.numel()
    nearest_loss = adaround.reconstruction_loss(nq, params, state, resnet.apply, calib,
                                                max_examples=ADAROUND_EXAMPLES)
    refined_loss = adaround.reconstruction_loss(rq, params, state, resnet.apply, calib,
                                                max_examples=ADAROUND_EXAMPLES)
    check(refined_loss < nearest_loss,
          f"[accuracy] reconstruction loss {refined_loss} not below nearest rounding's {nearest_loss}")
    x = m["x"]
    fp32, _ = resnet.apply(fparams, fstate, x)
    near, _ = resnet.apply(nq, nqs, x)
    near_rel = ((near - fp32).norm() / fp32.norm()).item()
    want = {"int8_gemm": 53, "int8_gemm_grouped": 1, "fused_dynamic_gemm": 0,
            "residual_boundary": 15, "depthwise_conv": 0}
    run = dict(apply=resnet.apply, params=params, state=state, q=cq, qs=cqs, x=x)
    _, out["refined"], msg = _path_run(torch, "accuracy resnet50", run, want, W4A8_RESNET_REL_L2_MAX,
                                       1000)
    out["refined_tree"] = (cq, cqs, x)
    phase("accuracy resnet50", t0, f"equalize {equalize_s:.3f} s (rel L2 {eq_rel:.3g} to the "
          f"fold); int4 guard on 2 batches of {ACCURACY_BATCH} {guard_s:.3f} s, guard "
          f"{sorted(guard)} as the plain run's; W4A8: AdaRound {ADAROUND_STEPS} steps on "
          f"{ADAROUND_EXAMPLES} images {refine_s:.3f} s ({moved} of {total} values moved, all within 1 LSB; hard "
          f"reconstruction loss {refined_loss:.6g} against nearest rounding's {nearest_loss:.6g}), "
          f"bias correction {correct_s:.3f} s; refined + corrected bs{RESNET_BATCH}: {msg}; "
          f"nearest-rounding W4A8 rel L2 {near_rel:.4f}")
    return out


def torchvision_mobilenet_state_dict(torch, num_classes: int = 10) -> dict:
    """A torchvision mobilenet_v2 state dict of random weights (the port's
    init, seed 0), laid out as torchvision names and shapes them: what a user
    of the reference hands to import-torch."""
    from quantnet_torch.models import mobilenet

    params, state = mobilenet.init(torch.Generator().manual_seed(SEED), num_classes=num_classes,
                                   device="cpu")
    sd = {}

    def conv_bn(conv_key, bn_key, layer, st):
        sd[f"{conv_key}.weight"] = layer["w"].permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
        sd[f"{bn_key}.weight"], sd[f"{bn_key}.bias"] = layer["bn"]["gamma"], layer["bn"]["beta"]
        sd[f"{bn_key}.running_mean"], sd[f"{bn_key}.running_var"] = st["mean"], st["var"]

    conv_bn("features.0.0", "features.0.1", params["conv_stem"], state["conv_stem"])
    names = sorted((k for k in params if k.startswith("block")), key=lambda k: int(k[5:]))
    for i, name in enumerate(names):
        bp, bs, t = params[name], state[name], f"features.{i + 1}.conv"
        if "expand" in bp:
            conv_bn(f"{t}.0.0", f"{t}.0.1", bp["expand"], bs["expand"])
            conv_bn(f"{t}.1.0", f"{t}.1.1", bp["dw"], bs["dw"])
            conv_bn(f"{t}.2", f"{t}.3", bp["project"], bs["project"])
        else:
            conv_bn(f"{t}.0.0", f"{t}.0.1", bp["dw"], bs["dw"])
            conv_bn(f"{t}.1", f"{t}.2", bp["project"], bs["project"])
    head = f"features.{len(names) + 1}"
    conv_bn(f"{head}.0", f"{head}.1", params["conv_head"], state["conv_head"])
    sd["classifier.1.weight"] = params["fc"]["w"].t().contiguous()
    sd["classifier.1.bias"] = params["fc"]["b"]
    return sd


def cli_phase(torch):
    """The port's CLI in process, on the card, in a temporary directory
    under build/: import-torch of the committed reference checkpoint ->
    quantize --scheme static -> evaluate -> bench -> serve --wire u8; then
    import-torch of a torchvision mobilenet_v2 state dict written there ->
    quantize --scheme w4a8 -> evaluate -> bench -> serve --wire u8."""
    import pathlib
    import tempfile

    from quantnet_torch.cli.main import main as cli

    t0 = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as d:
        args = ["--save-dir", f"{d}/saved", "--results-dir", f"{d}/results", "--data-dir", f"{d}/data",
                "--synthetic-train-size", "2048", "--synthetic-test-size", "2560"]
        cli(["import-torch", "--ckpt", str(root / "tests" / "fixtures" / "ref_ckpt_dict.pth"), *args])
        cli(["quantize", "--scheme", "static", *args])
        acc = cli(["evaluate", *args])
        bench = cli(["bench", "--batch-sizes", "1,32,1024", "--warmup", "3", "--iters", "20", *args])
        served = cli(["serve", "--wire", "u8", "--requests", "256", *args])
    check(set(acc) == {"fp32", "static"} and all(r["n"] == 2560 for r in acc.values()),
          f"[cli] evaluate: {sorted(acc)}")
    check(set(bench) == {"fp32", "static"} and all(
        bench[n][f"bs{b}"]["p50_ms"] > 0 for n in bench for b in (1, 32, 1024)), "[cli] bench")
    check(served["stats"]["requests"] == 256 and served["name"] == "static", "[cli] serve")
    phase("cli", t0, f"import-torch -> quantize static -> evaluate (top-1 fp32 "
          f"{acc['fp32']['top1']:.4f}, static {acc['static']['top1']:.4f}) -> bench (static bs1024 "
          f"p50 {bench['static']['bs1024']['p50_ms']:.4f} ms) -> serve u8 (256 requests, "
          f"{256 / served['seconds']:.1f} req/s)")

    # The accuracy tools through the CLI: every scheme with equalization, the
    # int4 guard, AdaRound and bias correction; the optimized artifact served.
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root / "build") as d:
        args = ["--save-dir", f"{d}/saved", "--results-dir", f"{d}/results", "--data-dir", f"{d}/data",
                "--synthetic-train-size", "2048", "--synthetic-test-size", "2560"]
        cli(["import-torch", "--ckpt", str(root / "tests" / "fixtures" / "ref_ckpt_dict.pth"), *args])
        t3 = time.perf_counter()
        cli(["quantize", "--scheme", "all", "--equalize", "--int4-guard", "50", "--adaround-steps",
             "20", "--bias-correct", *args])
        quantize_s = time.perf_counter() - t3
        with open(f"{d}/saved/optimized.json") as f:
            table = json.load(f)["metadata"]["policy"]
        acc = cli(["evaluate", *args])
        served = cli(["serve", "--scheme", "optimized", "--wire", "u8", "--requests", "256", *args])
    want = ["fp32", "bf16", "dynamic", "static", "weight_only", "weight_only_int4", "w4a8", "optimized"]
    check(list(acc) == want and all(r["n"] == 2560 for r in acc.values()),
          f"[cli accuracy] evaluate: {list(acc)}")
    check(isinstance(table, dict) and len(table) == 8 and set(table.values()) <= {"bf16", "weight_only"},
          f"[cli accuracy] optimized policy {table}")
    check(served["stats"]["requests"] == 256 and served["name"] == "optimized", "[cli accuracy] serve")
    phase("cli accuracy", t2, f"import-torch -> quantize all --equalize --int4-guard 50 "
          f"--adaround-steps 20 --bias-correct ({quantize_s:.2f} s; optimized keeps "
          f"{sorted(p for p, v in table.items() if v == 'bf16')} in bf16) -> evaluate (top-1 "
          + ", ".join(f"{n} {r['top1']:.4f}" for n, r in acc.items())
          + f") -> serve optimized u8 (256 requests, {256 / served['seconds']:.1f} req/s)")

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root / "build") as d:
        ckpt = f"{d}/mobilenet_v2.pth"
        torch.save(torchvision_mobilenet_state_dict(torch), ckpt)
        args = ["--model", "mobilenetv2", "--save-dir", f"{d}/saved", "--results-dir", f"{d}/results",
                "--data-dir", f"{d}/data", "--synthetic-train-size", "1024", "--synthetic-test-size",
                "1024"]
        cli(["import-torch", "--ckpt", ckpt, *args])
        cli(["quantize", "--scheme", "w4a8", "--calibration-batches", "2", *args])
        acc = cli(["evaluate", *args])
        bench = cli(["bench", "--batch-sizes", "1,32,256", "--warmup", "3", "--iters", "20", *args])
        served = cli(["serve", "--scheme", "w4a8", "--wire", "u8", "--requests", "256", *args])
    check(set(acc) == {"fp32", "w4a8"} and all(r["n"] == 1024 for r in acc.values()),
          f"[cli mobilenetv2] evaluate: {sorted(acc)}")
    check(set(bench) == {"fp32", "w4a8"} and all(
        bench[n][f"bs{b}"]["p50_ms"] > 0 for n in bench for b in (1, 32, 256)), "[cli mobilenetv2] bench")
    check(served["stats"]["requests"] == 256 and served["name"] == "w4a8", "[cli mobilenetv2] serve")
    phase("cli mobilenetv2", t1, f"import-torch (torchvision mobilenet_v2 state dict) -> quantize "
          f"w4a8 -> evaluate (top-1 fp32 {acc['fp32']['top1']:.4f}, w4a8 {acc['w4a8']['top1']:.4f}) -> "
          f"bench (w4a8 bs256 p50 {bench['w4a8']['bs256']['p50_ms']:.4f} ms at 32x32) -> serve u8 (256 "
          f"requests, {256 / served['seconds']:.1f} req/s)")


def bench_torch_phase():
    """bench_torch.py's measurement, run in this process; its lines printed."""
    import io

    import bench_torch

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_torch.main()
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1])
    check(rc == 0 and result["metric"] == bench_torch.METRIC and result["value"] > 0,
          f"bench_torch: rc {rc}, {lines[-1]}")
    phase("bench_torch", t0, f"roofline {lines[0]}")
    print(lines[-1], flush=True)


# [train]: the SimpleConvNet at full width on the synthetic CIFAR-10 split
# (the CLI's defaults: 12800 / 2560 images, bs128, sgd_cosine at lr 0.1)
# for two epochs with augmentation; ResNet-50 and MobileNetV2 1.0 at 224x224,
# bs32, ten train-mode steps on one batch; the convnet's first steps on the
# card and through the port on the CPU from the same weights, batches and
# random draws (a CPU generator), bs32.
TRAIN_SIZES = (12800, 2560)
TRAIN_BATCH = 128
# Above chance: 0.1 + 5 standard deviations of chance's top-1 on 2560 images
# (an H100 measured 0.2152 after the second epoch; the JAX package's run,
# runs/r3_cifar, 0.2748 and 0.2398 after its first two of 20).
TRAIN_TOP1_MIN = 0.13
BIG_BATCH = 32
BIG_IMAGE = 224
BIG_STEPS = 10
TWIN_BATCH = 32
TWIN_STEPS = 10
# A step on the card and the same step on the CPU differ by the f32
# products' summation orders alone (TF32 off in forward and backward). Held:
# the relative loss difference, and per leaf the median relative difference
# of its gradient, the worst leaf and step, over the leaves that the
# backward reaches before a max pool's gradient crosses channels: conv6 and
# the dense layers. A pool window whose two largest entries the f32 sums
# order differently on the two devices sends its gradient to another
# entry; that moves a few of conv6's output channels, and the next conv's
# data gradient spreads it over every weight below (medians of 3e-3-1e-2
# there, printed beside). The same steps at PyTorch's TF32 defaults (cuDNN's
# backward convs in TF32) run as a control that must exceed the gradient
# bound. The batches are seeded normal images: flat regions of the
# synthetic split tie many pool windows.
TWIN_LOSS_REL_MAX = 1e-4
TWIN_GRAD_REL_MAX = 1e-4
TWIN_HELD = ("conv6", "fc1", "fc2")
# [qat]: the tracked trained artifacts (runs/r3_cifar/saved), calibrated on
# the CLI's 16 batches of 128; the JAX QAT test's bound of the baked logits
# against the fake-quant graph's (tests/test_qat.py:86-126). ResNet-50 and
# MobileNetV2 start from their seeded init with BN statistics measured on the
# batch (BN_RECALIBRATION train-mode forwards: at init's statistics the folded
# ResNet-50's activations grow by orders of magnitude a stage). The graph as
# it trains adds each residual identity unquantized, where the baked tree
# adds it as the int8 block input dequantized (in the JAX package too:
# quantnet/models/resnet.py:329-339, mobilenet.py:236-242); so every baked
# tree is held against the fake-quant graph with its identities
# fake-quantized as the bake reads them (Flags(fake_quant_identity)), and
# planted bake faults must break the same bound. Between the two graphs of
# a deep tree, an activation that the f32 sums put on the other side of a
# rounding boundary moves by a whole step and so do its consumers: the deep
# trees are held to a relative L2 under QAT_DEEP_REL_L2, the JAX test's
# elementwise bound printed beside.
SAVED = "runs/r3_cifar/saved"
QAT_CALIBRATION_BATCHES = 16
QAT_RTOL, QAT_ATOL = 0.05, 0.15
QAT_DEEP_REL_L2 = 0.12
BIG_QAT_STEPS = 3
BN_RECALIBRATION = 30


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _tree_max_diff(torch, a, b) -> float:
    from quantnet_torch.train.trainer import tensor_leaves

    la, lb = tensor_leaves(a), tensor_leaves(b)
    scale = max(t.abs().max().item() for t in lb)
    return max((x.detach().cpu() - y.detach().cpu()).abs().max().item() for x, y in zip(la, lb)) / scale


def _steps(torch, dev, apply_fn, params, state, batches, *, generator, augment=True, lr=0.1,
           steps_per_epoch=100):
    """Train steps of the port's trainer on the given (images, labels)
    batches: (losses, params, state), the trees detached copies."""
    from quantnet_torch.core.config import TrainConfig
    from quantnet_torch.train.trainer import Optimizer, clone_tree, tensor_leaves, train_step

    params = clone_tree(params, dev, requires_grad=True)
    state = clone_tree(state, dev)
    opt = Optimizer(TrainConfig(epochs=1, lr=lr), steps_per_epoch)
    leaves = tensor_leaves(params)
    opt_state = opt.init(leaves)
    losses = []
    for x, y in batches:
        state, loss, _ = train_step(apply_fn, opt, params, state, opt_state, leaves, generator,
                                    x.to(dev), y.to(dev), augment=augment)
        losses.append(loss)
    _sync(torch, dev)
    return [float(v) for v in losses], clone_tree(params), clone_tree(state)


def _img_per_s(torch, dev, fn, images: int, iters: int = 5) -> float:
    fn()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(torch, dev)
    return images * iters / (time.perf_counter() - t0)


def train_phase(torch, dev, card):
    """[train]: the convnet trained two epochs on the synthetic split;
    ResNet-50 and MobileNetV2 1.0 ten train-mode steps each at 224x224; the
    convnet's steps on the card against the same steps on the CPU."""
    from quantnet_torch.core.config import TrainConfig
    from quantnet_torch.data.datasets import load_cifar10
    from quantnet_torch.models import convnet, mobilenet, resnet
    from quantnet_torch.train import trainer as tr

    t0 = time.perf_counter()
    train, test = load_cifar10("build/no-data", synthetic_train_size=TRAIN_SIZES[0],
                               synthetic_test_size=TRAIN_SIZES[1])
    params, state = convnet.init(torch.Generator().manual_seed(SEED), device=dev)
    trainer = tr.Trainer(convnet.apply, params, state, TrainConfig(epochs=2, batch_size=TRAIN_BATCH),
                         train, test, log=None, device=dev)
    trainer.train()
    hist = trainer.history
    check(all(math.isfinite(h["train_loss"]) and math.isfinite(h["test_loss"]) for h in hist),
          f"[train] convnet: non-finite losses {hist}")
    check(trainer.best_accuracy > TRAIN_TOP1_MIN,
          f"[train] convnet: test top-1 {trainer.best_accuracy} near chance")
    x = torch.from_numpy(train.images[:TRAIN_BATCH]).to(dev)
    y = torch.from_numpy(train.labels[:TRAIN_BATCH]).to(dev, torch.int64)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    conv_ips = _img_per_s(torch, dev, lambda: trainer._step(gen, x, y), TRAIN_BATCH, iters=20)
    phase("train", t0, f"convnet bs{TRAIN_BATCH} on {train.name} ({len(train)} / {len(test)}), 2 epochs "
          f"sgd_cosine with augmentation: train loss {hist[0]['train_loss']:.4f} -> "
          f"{hist[1]['train_loss']:.4f}, test top-1 {hist[0]['test_acc']:.4f} -> {hist[1]['test_acc']:.4f}; "
          f"epochs {hist[0]['seconds']:.2f} s and {hist[1]['seconds']:.2f} s (evaluation included); "
          f"train step {conv_ips:.1f} img/s; {card}")

    big = {}
    for name, mod, init in (
        ("resnet50", resnet, lambda g: resnet.init(g, depth=50, device=dev)),
        ("mobilenetv2", mobilenet, lambda g: mobilenet.init(g, device=dev)),
    ):
        t1 = time.perf_counter()
        p, s = init(torch.Generator().manual_seed(SEED))
        g = torch.Generator().manual_seed(SEED + 3)
        xb = torch.randn((BIG_BATCH, BIG_IMAGE, BIG_IMAGE, 3), generator=g).to(dev)
        yb = torch.randint(0, 1000, (BIG_BATCH,), generator=g).to(dev)
        losses, p2, s2 = _steps(torch, dev, mod.apply, p, s, [(xb, yb)] * BIG_STEPS,
                                generator=torch.Generator(device=dev).manual_seed(SEED), augment=False,
                                lr=0.05, steps_per_epoch=BIG_STEPS)
        moved = _tree_max_diff(torch, s2, s)
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"[train] {name}: losses {losses} do not fall")
        check(moved > 0, f"[train] {name}: BN running statistics did not move")
        opt_params = tr.clone_tree(p, dev, requires_grad=True)
        opt = tr.Optimizer(TrainConfig(epochs=1, lr=0.05), BIG_STEPS)
        leaves = tr.tensor_leaves(opt_params)
        opt_state = opt.init(leaves)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        ips = _img_per_s(torch, dev, lambda: tr.train_step(mod.apply, opt, opt_params, s, opt_state,
                                                              leaves, gen, xb, yb, augment=False),
                         BIG_BATCH)
        big[name] = ips
        phase(f"train {name}", t1, f"bs{BIG_BATCH} {BIG_IMAGE}x{BIG_IMAGE}, {BIG_STEPS} train-mode steps on one batch: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; BN running statistics moved (max {moved:.3g} "
              f"of the largest); train step {ips:.1f} img/s; {card}")

    # The convnet's steps on the card and on the CPU. Training from scratch
    # at lr 0.1 is chaotic (a last-place difference grows step by step, on
    # the CPU alone too), so each of the CPU run's ten steps is repeated on
    # the card from the CPU's state before it (weights, BN statistics,
    # momentum, the generator's state): the same weights, batches and draws.
    t2 = time.perf_counter()
    params, state = convnet.init(torch.Generator().manual_seed(SEED), device="cpu")
    g = torch.Generator().manual_seed(SEED + 4)
    batches = [(torch.randn((TWIN_BATCH, 32, 32, 3), generator=g), torch.randint(0, 10, (TWIN_BATCH,), generator=g))
               for _ in range(TWIN_STEPS)]
    twin = _twin_steps(torch, dev, tr, convnet.apply, params, state, batches)
    with _tf32_default(torch, tr):
        control = _twin_steps(torch, dev, tr, convnet.apply, params, state, batches)
    readings = (f"losses {twin['loss']:.3g} (bound {TWIN_LOSS_REL_MAX}), gradients' median at the worst held "
                f"leaf {twin['grad']:.3g} ({twin['leaf']}; bound {TWIN_GRAD_REL_MAX}); at PyTorch's TF32 "
                f"defaults {control['loss']:.3g}, {control['grad']:.3g} ({control['leaf']})")
    check(twin["loss"] < TWIN_LOSS_REL_MAX and twin["grad"] < TWIN_GRAD_REL_MAX,
          f"[train twin] card against CPU: {readings}")
    check(control["grad"] > TWIN_GRAD_REL_MAX,
          f"[train twin] the control with cuDNN's TF32 in the backward passes the bound: {readings}")
    phase("train twin", t2, f"convnet bs{TWIN_BATCH}, {TWIN_STEPS} steps on seeded normal images with "
          f"augmentation and dropout drawn from a CPU generator, each from the CPU run's state before it: "
          f"card against CPU, losses within {twin['loss']:.3g} relative (bound {TWIN_LOSS_REL_MAX}); "
          f"gradients, the median relative difference per leaf, held over {', '.join(TWIN_HELD)}: worst "
          f"{twin['grad']:.3g} at {twin['leaf']} (bound {TWIN_GRAD_REL_MAX}; the largest difference "
          f"{twin['grad_max']:.3g} of the largest gradient), below the max pools worst {twin['below']:.3g} "
          f"at {twin['below_leaf']}; weights after each step within {twin['param']:.3g} of the largest; "
          f"control at PyTorch's TF32 defaults (cuDNN on, cuBLAS off), which must exceed the bound: loss "
          f"{control['loss']:.3g}, held {control['grad']:.3g} at {control['leaf']} (largest "
          f"{control['grad_max']:.3g}), below the max pools {control['below']:.3g} at "
          f"{control['below_leaf']}, weights {control['param']:.3g}")


def _leaf_names(torch, tree, prefix="") -> list:
    """The paths of a tree's tensors, in tensor_leaves order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_leaf_names(torch, v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out.append(prefix + k)
    return out


def _twin_steps(torch, dev, tr, apply_fn, params, state, batches) -> dict:
    """The largest differences, card against CPU, over train steps on
    `batches`, each run on the card from the CPU run's state before it: of
    the loss (relative); of the gradients that the step hands the optimizer,
    per leaf the median of the relative difference, the worst of the
    TWIN_HELD layers' leaves ("grad") and of the others ("below"), with the
    largest difference of a held leaf to its largest gradient beside; of the
    weights after the step (to the largest). A bias before a train-mode BN
    is left out: the BN subtracts the batch mean, so its gradient is
    rounding noise."""
    from quantnet_torch.core.config import TrainConfig

    class Recording(tr.Optimizer):
        def update(self, leaves, grads, state):
            self.grads = [g.detach().to("cpu", copy=True) for g in grads]
            super().update(leaves, grads, state)

    names = _leaf_names(torch, params)
    compared = [i for i, n in enumerate(names)
                if not (n.endswith(".b") and isinstance(params[n.split(".")[0]].get("bn"), dict))]
    opt = Recording(TrainConfig(epochs=1, lr=0.1), len(batches))
    gopt = Recording(TrainConfig(epochs=1, lr=0.1), len(batches))
    gen = torch.Generator().manual_seed(SEED + 4)
    p = tr.clone_tree(params, "cpu", requires_grad=True)
    st = tr.clone_tree(state)
    leaves = tr.tensor_leaves(p)
    opt_state = opt.init(leaves)
    worst = {"loss": 0.0, "grad": 0.0, "leaf": None, "below": 0.0, "below_leaf": None, "grad_max": 0.0,
             "param": 0.0}
    for x, y in batches:
        before = (tr.clone_tree(p), tr.clone_tree(st), opt_state["count"],
                  [t.clone() for t in opt_state["trace"]], gen.get_state())
        st, loss, _ = tr.train_step(apply_fn, opt, p, st, opt_state, leaves, gen, x, y)
        gp = tr.clone_tree(before[0], dev, requires_grad=True)
        gstate = {"count": before[2], "trace": [t.to(dev) for t in before[3]]}
        ggen = torch.Generator()
        ggen.set_state(before[4])
        _, gloss, _ = tr.train_step(apply_fn, gopt, gp, tr.clone_tree(before[1], dev), gstate,
                                    tr.tensor_leaves(gp), ggen, x.to(dev), y.to(dev))
        torch.cuda.synchronize()
        worst["loss"] = max(worst["loss"], abs(float(gloss) - float(loss)) / abs(float(loss)))
        for i in compared:
            g, gg = opt.grads[i], gopt.grads[i]
            rel = ((gg - g).abs() / (g.abs() + 1e-3 * g.abs().max())).median().item()
            held = names[i].split(".")[0] in TWIN_HELD
            key = "grad" if held else "below"
            if rel >= worst[key]:
                worst[key], worst["leaf" if held else "below_leaf"] = rel, names[i]
            if held:
                worst["grad_max"] = max(worst["grad_max"], ((gg - g).abs().max() / g.abs().max()).item())
        worst["param"] = max(worst["param"], _tree_max_diff(torch, tr.clone_tree(gp, "cpu"), p))
    return worst


def _tf32_default(torch, tr):
    """A scope in which the train step leaves TF32 at PyTorch's defaults, on
    for cuDNN and off for cuBLAS: the step's no_tf32() replaced by one that
    sets those, so the backward convs run in TF32 (what the step's own
    scope is there to prevent) while the forward's convs and matmuls keep their own
    f32 scopes."""

    @contextlib.contextmanager
    def defaults():
        cudnn, cublas = torch.backends.cudnn, torch.backends.cuda.matmul
        before = cudnn.allow_tf32, cublas.allow_tf32
        cudnn.allow_tf32, cublas.allow_tf32 = True, False
        try:
            yield
        finally:
            cudnn.allow_tf32, cublas.allow_tf32 = before

    @contextlib.contextmanager
    def scope():
        saved = tr.no_tf32
        tr.no_tf32 = defaults
        try:
            yield
        finally:
            tr.no_tf32 = saved

    return scope()


def _within_qat_bound(got, ref) -> bool:
    return bool(((got - ref).abs() <= QAT_ATOL + QAT_RTOL * ref.abs()).all())


def _rel_l2(got, ref) -> float:
    return ((got - ref).norm() / ref.norm()).item()


def _planted_faults(torch, apply_fn, baked, state, x, ref) -> dict:
    """Bake faults planted in every quantized layer of a copy of the baked
    tree: the input quantized one zero point off while the GEMM constants
    keep the baked zero-point correction ("stale zero point"), and the
    weights' per-channel scales in reverse channel order, the GEMM constants
    built from them ("reversed scales"). -> {fault: (whether it stays within
    the QAT bound of `ref`, its max |diff|, its relative L2)}."""
    import dataclasses

    from quantnet_torch.core.types import ActQuant
    from quantnet_torch.ops.linear import gemm_constants
    from quantnet_torch.quantize.common import walk_layers

    def stale(path, layer):
        aq = layer.get("aq")
        if not isinstance(aq, ActQuant) or "gemm" not in layer:
            return layer
        return {**layer, "aq": ActQuant(scale=aq.scale, zero_point=aq.zero_point + 1)}

    def reversed_scales(path, layer):
        if "gemm" not in layer:
            return layer
        out = {**layer, "w": dataclasses.replace(layer["w"], scale=layer["w"].scale.flip(-1))}
        return {**out, "gemm": gemm_constants(out)}

    out = {}
    for fault, fn in (("stale zero point", stale), ("reversed scales", reversed_scales)):
        logits, _ = apply_fn(walk_layers(baked, fn), state, x)
        out[fault] = (_within_qat_bound(logits, ref), (logits - ref).abs().max().item(), _rel_l2(logits, ref))
    return out


def _baked_checks(torch, name, apply_fn, baked, fq_tree, state, x, want, deep=False) -> dict:
    """A baked QAT tree on the card: one forward with every count set to 0
    just before it (its launches, held to `want`), bit-equal to its plain
    run; every K1, K3 and K4 launch of another forward bit-equal to its
    plain version; its logits against the fake-quant graph that the bake
    deploys (Flags(fake_quant_identity): the residual identities
    fake-quantized as the baked tree reads them), within the JAX QAT test's
    bound (`deep`: a relative L2 under QAT_DEEP_REL_L2), which every planted
    bake fault must break. Returns the launches, max |baked - that graph|
    and the relative L2, whether the JAX test's bound holds, the relative L2
    to the graph as it trained (the identities unquantized), and the planted
    faults' readings."""
    from quantnet_torch.core.config import Flags

    torch.cuda.synchronize()
    _zero_launch_counts()
    logits, _ = apply_fn(baked, state, x)
    torch.cuda.synchronize()
    launches = _launch_counts()
    check(bool(torch.isfinite(logits).all()), f"[{name}] non-finite logits")
    check(all(launches[k] == v for k, v in want.items()),
          f"[{name}] launches {launches}, expected {want}")
    plain, _ = apply_fn(baked, state, x, flags=Flags(plain=True))
    check(torch.equal(logits.view(torch.int32), plain.view(torch.int32)),
          f"[{name}] baked forward vs plain versions: max |diff| {(logits - plain).abs().max().item()}")
    with held_launches(torch) as rec:
        apply_fn(baked, state, x)
    held = held_counts(rec)
    check(all(held[k] == v for k, v in want.items() if v), f"[{name}] held launches {held}, expected {want}")
    ref, _ = apply_fn(fq_tree, state, x, flags=Flags(fake_quant_identity=True))
    trained, _ = apply_fn(fq_tree, state, x)
    out = {"launches": launches, "err": (logits - ref).abs().max().item(), "rel": _rel_l2(logits, ref),
           "jax_bound": _within_qat_bound(logits, ref), "trained_rel": _rel_l2(logits, trained),
           "faults": _planted_faults(torch, apply_fn, baked, state, x, ref)}
    bound = f"relative L2 {QAT_DEEP_REL_L2}" if deep else f"rtol {QAT_RTOL}, atol {QAT_ATOL}"
    check(out["rel"] < QAT_DEEP_REL_L2 if deep else out["jax_bound"],
          f"[{name}] baked logits vs the fake-quant graph's: max |diff| {out['err']}, relative L2 "
          f"{out['rel']} (max|logit| {ref.abs().max().item()}; bound {bound})")
    check(all(f[2] >= QAT_DEEP_REL_L2 if deep else not f[0] for f in out["faults"].values()),
          f"[{name}] a planted bake fault within the bound ({bound}): {out['faults']}")
    return out


def _fault_line(out) -> str:
    return ", ".join(f"{k}: max |diff| {v[1]:.4f}, relative L2 {v[2]:.4f}" for k, v in out["faults"].items())


def _qat_split(torch, prof) -> dict:
    """Device ms of a QAT step's trace by part: the fake quantizers (their
    forward ranges and their clip's backward), the convs and matmuls
    (forward and backward), the optimizer (its range), the rest."""
    split = {"fake quant": 0.0, "convs": 0.0, "optimizer": 0.0, "other": 0.0}
    conv_names = ("convolution", "Convolution", "aten::mm", "aten::addmm", "aten::matmul", "MmBackward",
                  "AddmmBackward")

    def category(e):
        chain = []
        while e is not None:
            chain.append(e.name)
            e = e.cpu_parent
        if any(n == "fake_quant" or "ClipBackward" in n for n in chain):
            return "fake quant"
        if any(n == "optimizer" for n in chain):
            return "optimizer"
        if any(c in n for n in chain for c in conv_names):
            return "convs"
        return "other"

    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels:
            split[category(e)] += sum(k.duration for k in e.kernels) / 1e3
    return split


def _profiled_qat_steps(torch, dev, apply_fn, qp, qs, x, y, steps=5):
    """A few QAT train steps under torch.profiler, the fake quantizers and
    the optimizer in named ranges -> ms per step by part."""
    from quantnet_torch.core.config import TrainConfig
    from quantnet_torch.ops import conv as ops_conv
    from quantnet_torch.ops import linear as ops_linear
    from quantnet_torch.train import trainer as tr

    def ranged(fn, label):
        def wrapped(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return wrapped

    saved = [(m, n, getattr(m, n)) for m in (ops_conv, ops_linear)
             for n in ("fake_quant_act_ste", "fake_quant_weight_ste")]
    saved.append((tr.Optimizer, "update", tr.Optimizer.update))
    for m, n, f in saved:
        setattr(m, n, ranged(f, "optimizer" if n == "update" else "fake_quant"))
    try:
        params = tr.clone_tree(qp, dev, requires_grad=True)
        opt = tr.Optimizer(TrainConfig(epochs=1, lr=0.01, grad_clip_norm=1.0), steps)
        leaves = tr.tensor_leaves(params)
        opt_state = opt.init(leaves)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        step = lambda: tr.train_step(apply_fn, opt, params, qs, opt_state, leaves, gen, x, y)  # noqa: E731
        step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    return {k: v / steps for k, v in _qat_split(torch, prof).items()}


def _load(torch, dev, name):
    import pathlib

    from quantnet_torch.train import checkpoint as ckpt

    path = pathlib.Path(__file__).resolve().parent / SAVED / name
    check(path.with_suffix(".json").exists(), f"[qat] {path}.json is missing")
    tree, _ = ckpt.load_artifact(str(path), device=dev)
    return tree["params"], tree["state"]


def qat_phase(torch, dev, card):
    """[qat]: QAT from the tracked trained convnet (8-bit, and W4A8 from its
    AdaRound-refined w4a8 artifact), and a few QAT steps of ResNet-50 and
    MobileNetV2 1.0 at 224x224; each baked tree held on the card; the QAT
    step's device-time split; the PTQ-collapse demonstration."""
    from quantnet_torch.core.config import TrainConfig
    from quantnet_torch.data.datasets import load_cifar10
    from quantnet_torch.evaluation.evaluator import Evaluator
    from quantnet_torch.models import convnet, mobilenet, resnet
    from quantnet_torch.quantize import qat, static
    from quantnet_torch.train.trainer import Optimizer, Trainer, clone_tree, tensor_leaves, train_step

    t0 = time.perf_counter()
    train, test = load_cifar10("build/no-data", synthetic_train_size=TRAIN_SIZES[0],
                               synthetic_test_size=TRAIN_SIZES[1])
    calib = [torch.from_numpy(x).to(dev) for x, _ in
             list(train.batches(TRAIN_BATCH, drop_remainder=True))[:QAT_CALIBRATION_BATCHES]]
    ev = Evaluator(convnet.apply, test, batch_size=512, device=dev)
    params, state = _load(torch, dev, "fp32")
    top1 = {"fp32": ev.evaluate(params, state)["top1"]}
    sp, ss = static.quantize(params, state, convnet.apply, calib)
    top1["static"] = ev.evaluate(sp, ss)["top1"]
    xe = torch.from_numpy(test.images[:TRAIN_BATCH]).to(dev)
    cfg = TrainConfig(epochs=1, batch_size=TRAIN_BATCH, lr=0.01, grad_clip_norm=1.0)
    qp, qs = qat.prepare(params, state, convnet.apply, calib)
    trainer = Trainer(convnet.apply, qp, qs, cfg, train, test, log=None, device=dev)
    t1 = time.perf_counter()
    qp, qs = trainer.train()
    qat_s = time.perf_counter() - t1
    baked = qat.bake(qp)
    top1["qat"] = ev.evaluate(baked, qs)["top1"]
    held = {"convnet": _baked_checks(torch, "qat convnet", convnet.apply, baked, qp, qs, xe,
                                     {"int8_gemm": 8, "int8_gemm_grouped": 0, "fused_dynamic_gemm": 0})}
    xt = torch.from_numpy(train.images[:TRAIN_BATCH]).to(dev)
    yt = torch.from_numpy(train.labels[:TRAIN_BATCH]).to(dev, torch.int64)
    split = _profiled_qat_steps(torch, dev, convnet.apply, qp, qs, xt, yt)
    qat_ips = _img_per_s(torch, dev, lambda: trainer._step(
        torch.Generator(device=dev).manual_seed(SEED), xt, yt), TRAIN_BATCH, iters=20)
    phase("qat", t0, f"the tracked convnet ({SAVED}/fp32) on {test.name}: top-1 fp32 {top1['fp32']:.4f}, "
          f"static PTQ {top1['static']:.4f}, QAT (1 epoch, clip 1.0, {qat_s:.2f} s; fake-quant graph "
          f"{trainer.best_accuracy:.4f}) {top1['qat']:.4f}; baked forward bit-equal to its plain run, "
          f"launches {held['convnet']['launches']}, every K1 launch bit-equal, max |baked - fake quant| "
          f"{held['convnet']['err']:.4f} (bound rtol {QAT_RTOL}, atol {QAT_ATOL}); planted bake faults "
          f"({_fault_line(held['convnet'])}); QAT step bs{TRAIN_BATCH} {qat_ips:.1f} img/s, device ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + f"; {card}")

    t2 = time.perf_counter()
    wp, ws = _load(torch, dev, "w4a8")
    wq, wqs = qat.prepare(qat.dequantize_tree(wp), ws, convnet.apply, calib, weight_bits=4,
                          weight_group_size=W4A8_GROUP, fold=False)
    wtrainer = Trainer(convnet.apply, wq, wqs, cfg, train, test, log=None, device=dev)
    wq, wqs = wtrainer.train()
    wbaked = qat.bake(wq)
    top1["w4a8"] = ev.evaluate(wp, ws)["top1"]
    top1["qat_w4a8"] = ev.evaluate(wbaked, wqs)["top1"]
    held["convnet_w4a8"] = _baked_checks(torch, "qat_w4a8 convnet", convnet.apply, wbaked, wq, wqs, xe,
                                         {"int8_gemm": 8, "int8_gemm_grouped": 2})
    phase("qat w4a8", t2, f"init from {SAVED}/w4a8 (dequantized, not re-folded), 1 epoch: top-1 of "
          f"the w4a8 artifact {top1['w4a8']:.4f}, of qat_w4a8 {top1['qat_w4a8']:.4f}; baked forward bit-equal to its plain run, "
          f"launches {held['convnet_w4a8']['launches']}, every K1 launch (grouped-K included) bit-equal, "
          f"max |baked - fake quant| {held['convnet_w4a8']['err']:.4f}; planted bake faults "
          f"({_fault_line(held['convnet_w4a8'])})")

    for name, mod, init, want in (
        ("resnet50", resnet, lambda g: resnet.init(g, depth=50, device=dev),
         {"int8_gemm": 54, "residual_boundary": 15}),
        ("mobilenetv2", mobilenet, lambda g: mobilenet.init(g, device=dev),
         {"int8_gemm": 36, "depthwise_conv": 17}),
    ):
        t3 = time.perf_counter()
        p, s = init(torch.Generator().manual_seed(SEED))
        g = torch.Generator().manual_seed(SEED + 5)
        xb = torch.randn((BIG_BATCH, BIG_IMAGE, BIG_IMAGE, 3), generator=g).to(dev)
        yb = torch.randint(0, 1000, (BIG_BATCH,), generator=g).to(dev)
        with torch.no_grad():
            for _ in range(BN_RECALIBRATION):
                s = mod.apply(p, s, xb, train=True)[1]
        bq, bqs = qat.prepare(p, s, mod.apply, [xb])
        bq = clone_tree(bq, dev, requires_grad=True)
        opt = Optimizer(TrainConfig(epochs=1, lr=0.001, grad_clip_norm=1.0), BIG_QAT_STEPS)
        leaves = tensor_leaves(bq)
        opt_state = opt.init(leaves)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        losses = [float(train_step(mod.apply, opt, bq, bqs, opt_state, leaves, gen, xb, yb,
                                   augment=False)[1]) for _ in range(BIG_QAT_STEPS)]
        check(all(math.isfinite(v) for v in losses), f"[qat {name}] losses {losses}")
        bq = clone_tree(bq)
        bbaked = qat.bake(bq)
        held[name] = r = _baked_checks(torch, f"qat {name}", mod.apply, bbaked, bq, bqs, xb, want, deep=True)
        phase(f"qat {name}", t3, f"bs{BIG_BATCH} {BIG_IMAGE}x{BIG_IMAGE}, init with BN statistics of "
              f"{BN_RECALIBRATION} train-mode forwards: prepare (fold, min-max on the batch), {BIG_QAT_STEPS} QAT steps (loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}), bake; baked forward bit-equal to its plain run, launches "
              f"{r['launches']}, every K1 / K3 / K4 launch bit-equal; baked against the fake-quant graph "
              f"it deploys: max |diff| {r['err']:.4f}, relative L2 {r['rel']:.4g} (bound {QAT_DEEP_REL_L2}; "
              f"the JAX test's elementwise bound {'holds' if r['jax_bound'] else 'does not hold'}); against "
              f"the graph as it trained (identities unquantized) relative L2 {r['trained_rel']:.4f}; "
              f"planted bake faults, which must exceed the bound ({_fault_line(r)})")

    t4 = time.perf_counter()
    demo = ptq_collapse(torch, dev)
    check(abs(demo["rescaled"] - demo["fp32"]) <= 1e-6 and demo["ptq"] <= demo["fp32"] - 0.08
          and demo["qat"] >= demo["ptq"] + 0.05, f"[qat collapse] {demo}")
    phase("qat collapse", t4, f"tests/test_qat.py's PTQ-collapse demonstration on the card: top-1 fp32 "
          f"{demo['fp32']:.4f} (rescaled {demo['rescaled']:.4f}), per-tensor PTQ {demo['ptq']:.4f}, "
          f"per-tensor QAT {demo['qat']:.4f}")
    return {"launches": {k: v["launches"] for k, v in held.items()}, "top1": top1, "split": split}


def cli_train_phase(torch):
    """[cli train]: python -m quantnet_torch train -> qat -> evaluate in
    process, in a temporary directory under build/."""
    import pathlib
    import tempfile

    from quantnet_torch.cli.main import main as cli

    t0 = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as d:
        args = ["--save-dir", f"{d}/saved", "--results-dir", f"{d}/results", "--data-dir", f"{d}/data",
                "--synthetic-train-size", "2048", "--synthetic-test-size", "2560"]
        trained = cli(["train", "--epochs", "1", *args])
        tuned = cli(["qat", "--epochs", "1", "--calibration-batches", "2", *args])
        acc = cli(["evaluate", *args])
    check(len(trained["history"]) == 1 and tuned["name"] == "qat", f"[cli train] {trained} {tuned}")
    check(list(acc) == ["fp32", "qat"] and all(r["n"] == 2560 for r in acc.values()),
          f"[cli train] evaluate: {list(acc)}")
    phase("cli train", t0, f"train (1 epoch on 2048 images, best top-1 {trained['best_accuracy']:.4f}) -> "
          f"qat (1 epoch, fake-quant graph {tuned['best_accuracy']:.4f}) -> evaluate (top-1 fp32 "
          f"{acc['fp32']['top1']:.4f}, qat {acc['qat']['top1']:.4f})")


def _collapse_init(torch, device):
    """The PTQ-collapse demo's model (tests/test_qat.py:113-126): a 3x3/2
    conv to 16 channels with relu, a global mean, an fc to 4 classes."""
    g = torch.Generator().manual_seed(0)
    return {"conv1": {"w": (torch.randn((3, 3, 3, 16), generator=g) * 0.2).to(device),
                      "b": torch.zeros(16, device=device)},
            "fc": {"w": (torch.randn((16, 4), generator=g) * 0.3).to(device),
                   "b": torch.zeros(4, device=device)}}, {}


def _collapse_apply(params, state, x, *, train=False, generator=None, capture=None):
    from quantnet_torch.models import capture_input
    from quantnet_torch.ops.conv import conv2d
    from quantnet_torch.ops.linear import linear

    capture_input(capture, "conv1", x, ("conv", 2, "SAME", "relu"))
    x = conv2d(params["conv1"], x, stride=2, padding="SAME", activation="relu").mean(dim=(1, 2))
    capture_input(capture, "fc", x, ("linear", None, None, None))
    return linear(params["fc"], x), state


def ptq_collapse(torch, device) -> dict:
    """The port of the JAX package's test_qat_recovers_ptq_collapse
    (tests/test_qat.py:129-182): train the small model, spread its conv
    channels over three decades by a function-preserving rescale (relu's
    positive homogeneity), so per-tensor static PTQ rounds most channels to
    zero; a per-tensor QAT finetune of 4 epochs learns weights that fit the
    grid again. Returns the top-1 of fp32, the rescaled fp32, PTQ and QAT,
    and the baked tree and its inputs."""
    from quantnet_torch.core.config import TrainConfig
    from quantnet_torch.data.datasets import make_synthetic
    from quantnet_torch.evaluation.evaluator import Evaluator
    from quantnet_torch.quantize import qat, static
    from quantnet_torch.train.trainer import Trainer

    train, test = make_synthetic(4, 16, 1024, 512, seed=11, signal_max=6.0)
    params, state = _collapse_init(torch, device)
    params, state = Trainer(_collapse_apply, params, state,
                            TrainConfig(epochs=6, batch_size=128, lr=0.05, seed=0), train, test,
                            augment=False, log=None, device=device).train()
    ev = Evaluator(_collapse_apply, test, batch_size=128, top_k=2, device=device)
    f = torch.logspace(-2, 1, 16, device=device)
    rescaled = {"conv1": {"w": params["conv1"]["w"] * f, "b": params["conv1"]["b"] * f},
                "fc": {"w": params["fc"]["w"] / f[:, None], "b": params["fc"]["b"]}}
    calib = [torch.from_numpy(x).to(device) for x, _ in train.batches(128, drop_remainder=True)][:2]
    sp, ss = static.quantize(rescaled, state, _collapse_apply, calib, per_channel=False)
    qp, qs = qat.prepare(rescaled, state, _collapse_apply, calib, per_channel=False)
    qtrainer = Trainer(_collapse_apply, qp, qs, TrainConfig(epochs=4, batch_size=128, lr=0.01, seed=1),
                       train, test, augment=False, log=None, device=device)
    qp, qs = qtrainer.train()
    baked = qat.bake(qp)
    return {"fp32": ev.evaluate(params, state)["top1"], "rescaled": ev.evaluate(rescaled, state)["top1"],
            "ptq": ev.evaluate(sp, ss)["top1"], "qat": ev.evaluate(baked, qs)["top1"],
            "baked": baked, "fake_quant": qp, "images": torch.from_numpy(test.images[:128]).to(device)}


# [parallel]: two ranks spawned (not forked: CUDA is live in this process),
# sharing the card over gloo. The static convnet's sharded eval at a global
# bs1024 over the synthetic CIFAR-10 test split (2560 images, the last
# batch padded and masked); one convnet train step at a global bs256 with
# augmentation (crop, flip, rotation, jitter) and dropout, against one
# process's step on the global batch: the loss within PARALLEL_LOSS_REL,
# and per leaf max |diff| <= rtol * max |leaf| + atol. The f32 sums of a
# batch's halves and of the whole batch part in the last places; where a
# max pool's window holds a near-tie, the gradient goes to another entry,
# and the convs' weights below it move by a routing step, not an ulp (as in
# [train twin]). So the BN statistics (forward only) and fc1 / fc2 are held
# to PARALLEL_TIGHT, the convs' params to PARALLEL_CONV. In a CPU rehearsal
# at 32x32 and a global bs16 the loss agreed to 3e-7 relative, fc1 / fc2 to
# 1e-7, and conv1-conv4's weights moved by up to 1.6e-3 of their largest.
PARALLEL_RANKS = 2
PARALLEL_FULL = dict(eval_batch=1024, test_size=2560, train_batch=256, calib=(2, 64), probe=256,
                     epoch_images=2048, epoch_test=512, epoch_batch=128)
PARALLEL_LOSS_REL = 1e-5
PARALLEL_TIGHT = (1e-5, 1e-6)  # rtol, atol: the BN statistics and fc1 / fc2
PARALLEL_CONV = (1e-2, 1e-6)  # the convs' params, below the pools
PARALLEL_TIMEOUT_S = 600
# [serve dp]: the static convnet's engine over [cuda:0, cuda:0] (two shards,
# a graph each) against the one-replica engine, the same trickle and burst.
SERVE_DP_BURST = 2048
# [scaling]: weak scaling at the JAX sweep's per-device batch.
SCALING_PER_DEVICE = 256
# [cli experiment]: the schemes the report must list, in the JAX CLI's order.
EXPERIMENT_SCHEMES = ("fp32", "bf16", "dynamic", "static", "weight_only", "weight_only_int4", "w4a8",
                      "optimized", "qat")


def _tree_digest(torch, tree) -> str:
    """sha256 of a tree's tensors' bytes, in tensor_leaves order."""
    import hashlib

    from quantnet_torch.train.trainer import tensor_leaves

    h = hashlib.sha256()
    for t in tensor_leaves(tree):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _leaf_excess(torch, got, want, bounds) -> dict:
    """{group: (worst max|diff| / (rtol * max|leaf| + atol), the leaf)} over
    the trees' leaves, `bounds(name)` -> (group, rtol, atol)."""
    from quantnet_torch.train.trainer import tensor_leaves

    out = {}
    for name, a, b in zip(_leaf_names(torch, want), tensor_leaves(got), tensor_leaves(want)):
        group, rtol, atol = bounds(name)
        d = (a.detach() - b.detach()).abs().max().item()
        excess = d / (rtol * b.detach().abs().max().item() + atol)
        if excess >= out.get(group, (-1.0, ""))[0]:
            out[group] = (excess, name)
    return out


def _parallel_bounds(name: str):
    if name.startswith("s."):
        return ("BN statistics", *PARALLEL_TIGHT)
    if name.startswith(("p.fc1", "p.fc2")):
        return ("fc1 / fc2", *PARALLEL_TIGHT)
    return ("convs", *PARALLEL_CONV)


def _parallel_rank(rank: int, world: int, port: int) -> dict:
    """One rank of [parallel]; rank 0 also runs the one-process references
    and holds the ranks' results against each other."""
    import numpy as np
    import torch

    from quantnet_torch.core.config import TrainConfig
    from quantnet_torch.core.types import ActQuant
    from quantnet_torch.data.datasets import make_synthetic
    from quantnet_torch.entry import static_entry
    from quantnet_torch.models import convnet
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.parallel import mesh as meshlib
    from quantnet_torch.parallel import steps
    from quantnet_torch.quantize import static
    from quantnet_torch.quantize.fold import fold_model
    from quantnet_torch.train import trainer as tr

    cfg = PARALLEL_FULL
    dev = meshlib.init_distributed(f"127.0.0.1:{port}", world, rank, device="cuda")
    mesh = meshlib.make_mesh()
    one = meshlib.Mesh("local", (dev,), 1)
    out = {"backend": mesh.backend, "device": str(dev)}

    def sync():
        _sync(torch, dev)

    # The static convnet's sharded evaluation, rank 0's tree broadcast.
    _, (q, qs, _) = static_entry(dev, batch_size=8, seed=SEED)
    q = meshlib.replicate(mesh, q)
    _, test = make_synthetic(10, 32, 8, cfg["test_size"], name="cifar10-synthetic")
    bs, n = cfg["eval_batch"], len(test)
    lbs = bs // world

    def evaluate(m, batches, rows, offset):
        counts = np.zeros(3, np.int64)
        for b, (x, y) in enumerate(batches):
            valid = torch.from_numpy(b * bs + offset + np.arange(rows) < n).to(dev)
            o = steps.eval_step(m, convnet.apply, q, qs, torch.from_numpy(x).to(dev),
                                torch.from_numpy(y).to(dev).long(), valid)
            counts += [o["top1"], o["top5"], o["n"]]
        return counts.tolist()

    sync()
    int8_gemm.launches = 0
    t0 = time.perf_counter()
    out["eval"] = evaluate(mesh, test.batches(bs, process_shard=True, pad_remainder=True), lbs, rank * lbs)
    sync()
    out["eval_s"], out["eval_launches"] = time.perf_counter() - t0, int8_gemm.launches
    if rank == 0:
        out["eval_one"] = evaluate(one, test.batches(bs, pad_remainder=True), bs, 0)

    # One convnet train step, augmentation and dropout on.
    params, state = convnet.init(torch.Generator().manual_seed(SEED), device=dev)
    g = torch.Generator().manual_seed(SEED + 5)
    tb = cfg["train_batch"]
    images = torch.randn((tb, 32, 32, 3), generator=g)
    labels = torch.randint(0, 10, (tb,), generator=g)
    step_cfg = TrainConfig(epochs=1, batch_size=tb, lr=0.1)

    def step(m, x, y):
        opt = tr.Optimizer(step_cfg, 10)
        p = tr.clone_tree(params, requires_grad=True)
        leaves = tr.tensor_leaves(p)
        opt_state = opt.init(leaves)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        kw = dict(augment=True, rotation_deg=15.0, color_jitter=0.2)
        if m is None:
            ns, loss, _ = tr.train_step(convnet.apply, opt, p, state, opt_state, leaves, gen, x, y, **kw)
        else:
            ns, loss, _ = steps.train_step(m, convnet.apply, opt, p, state, opt_state, leaves, gen, x, y,
                                           **kw)
        return tr.clone_tree(p), ns, float(loss)

    dp = step(mesh, *meshlib.shard_batch(mesh, (images, labels)))
    digests = meshlib.gather_objects(_tree_digest(torch, {"p": dp[0], "s": dp[1]}))
    if rank == 0:
        sp = step(None, images.to(dev), labels.to(dev))
        out["step"] = dict(
            ranks_identical=len(set(digests)) == 1, loss=dp[2], loss_one=sp[2],
            loss_rel=abs(dp[2] - sp[2]) / abs(sp[2]),
            leaves=_leaf_excess(torch, {"p": dp[0], "s": dp[1]}, {"p": sp[0], "s": sp[1]},
                                _parallel_bounds))

    # Cross-process calibration: each rank observes its rows of each batch.
    fparams, fstate = fold_model(params, state)
    g = torch.Generator().manual_seed(SEED + 6)
    calib = [torch.randn((cfg["calib"][1], 32, 32, 3), generator=g) for _ in range(cfg["calib"][0])]
    local = [meshlib.shard_batch(mesh, c) for c in calib]
    probe = torch.randn((cfg["probe"], 32, 32, 3), generator=g).to(dev)
    out["calibration"] = {}
    for observer in ("minmax", "histogram"):
        own = static.observe(convnet.apply, fparams, fstate, local, observer=observer)
        qp = static.calibrate(convnet.apply, fparams, fstate, local, observer=observer)
        baked, _ = static.bake(fparams, fstate, qp, skip_first_layer=True)
        scales = torch.cat([torch.stack([v["aq"].scale.float(), v["aq"].zero_point.float()])
                            for _, v in sorted(baked.items()) if isinstance(v.get("aq"), ActQuant)])
        sync()
        int8_gemm.launches = 0
        logits = convnet.apply(baked, {}, probe)[0]
        sync()
        launches = int8_gemm.launches
        mine = {"qp": {k: (a.cpu(), b.cpu()) for k, (a, b) in qp.items()}, "scales": scales.cpu(),
                "logits": logits.cpu(), "own": {k: o.to("cpu") for k, o in own.items()}}
        both = meshlib.gather_objects(mine)
        if rank == 0:
            a, b = both
            same = all(torch.equal(x, y) for k in a["qp"] for x, y in zip(a["qp"][k], b["qp"][k]))
            merged = all(
                all(torch.equal(x.cpu(), y) for x, y in zip(
                    type(a["own"][k]).merge_all([a["own"][k], b["own"][k]]).to(dev).qparams(), a["qp"][k]))
                for k in a["qp"])
            differ = sum(not torch.equal(a["own"][k].qparams()[0], b["own"][k].qparams()[0])
                         for k in a["qp"])
            out["calibration"][observer] = dict(
                qparams_identical=same, scales_identical=torch.equal(a["scales"], b["scales"]),
                logits_identical=torch.equal(a["logits"], b["logits"]), merge_all_equal=merged,
                layers=len(a["qp"]), own_differ=differ, launches=launches)

    # A Trainer epoch over the two ranks.
    train, test2 = make_synthetic(10, 32, cfg["epoch_images"], cfg["epoch_test"], name="cifar10-synthetic")
    p2, s2 = convnet.init(torch.Generator().manual_seed(SEED), device=dev)
    trainer = tr.Trainer(convnet.apply, p2, s2, TrainConfig(epochs=1, batch_size=cfg["epoch_batch"],
                                                            lr=0.1, seed=SEED),
                         train, test2, mesh=mesh, log=None)
    sync()
    t0 = time.perf_counter()
    p2, s2 = trainer.train(reload_best=False)
    sync()
    out["epoch_s"] = time.perf_counter() - t0
    digests = meshlib.gather_objects(_tree_digest(torch, {"p": p2, "s": s2}))
    out["epoch"] = dict(ranks_identical=len(set(digests)) == 1, history=trainer.history)
    torch.distributed.destroy_process_group()
    return out


def _parallel_worker(rank, world, port, results, target):
    """A spawned rank: its result of target(rank, world, port), or its
    traceback, onto `results`."""
    import traceback

    try:
        results.put((rank, True, target(rank, world, port)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_phase(torch, card) -> dict:
    """[parallel]: two ranks spawned, sharing the card over gloo (the
    backend printed by each); a failed rank, check or collective, or a rank
    that outlives PARALLEL_TIMEOUT_S, fails the phase."""
    t0 = time.perf_counter()
    got = _spawn_ranks(torch, "parallel", _parallel_rank, PARALLEL_RANKS)
    r0, r1 = got[0], got[1]
    check(r0["backend"] == r1["backend"] == "gloo", f"[parallel] backends {r0['backend']}, {r1['backend']}")
    check(r0["eval"] == r1["eval"] == r0["eval_one"],
          f"[parallel] sharded counts {r0['eval']} / {r1['eval']}, one process {r0['eval_one']}")
    check(r0["eval_launches"] > 0, "[parallel] the sharded eval launched no int8_gemm")
    st = r0["step"]
    check(st["ranks_identical"], "[parallel] the ranks' params differ after the step")
    check(st["loss_rel"] <= PARALLEL_LOSS_REL, f"[parallel] step loss {st['loss']} against one "
          f"process's {st['loss_one']}: rel {st['loss_rel']:.3e} > {PARALLEL_LOSS_REL}")
    for group, (excess, leaf) in st["leaves"].items():
        check(excess <= 1.0, f"[parallel] {group}: {leaf} at {excess:.3f}x its bound")
    for observer, c in r0["calibration"].items():
        check(c["qparams_identical"] and c["scales_identical"] and c["logits_identical"],
              f"[parallel] {observer} calibration: ranks differ {c}")
        check(c["merge_all_equal"], f"[parallel] {observer}: not merge_all of the ranks' observers")
        check(c["launches"] > 0, f"[parallel] {observer}: the baked forward launched no int8_gemm")
    check(r0["epoch"]["ranks_identical"] and r1["epoch"]["ranks_identical"],
          "[parallel] the ranks' params differ after the Trainer epoch")
    h = r0["epoch"]["history"][0]
    check(math.isfinite(h["train_loss"]) and math.isfinite(h["test_loss"]), f"[parallel] epoch {h}")
    top1, top5, rows = r0["eval"]
    cal = "; ".join(f"{o} {c['layers']} layers bit-identical on both ranks and equal to merge_all here "
                    f"(own observers differ at {c['own_differ']}), baked forward {c['launches']} "
                    "int8_gemm" for o, c in r0["calibration"].items())
    cfg = PARALLEL_FULL
    phase("parallel", t0, f"{card}; 2 ranks on {r0['device']}, backend {r0['backend']} (ranks share a "
          f"card): static convnet sharded eval bs{cfg['eval_batch']} top-1 {top1} / top-5 {top5} of "
          f"{rows}, equal to one process's; {r0['eval_launches']} int8_gemm on rank 0 in "
          f"{r0['eval_s']:.3f} s; train step bs{cfg['train_batch']} (aug + dropout) loss {st['loss']!r} "
          f"against one process's {st['loss_one']!r} (rel {st['loss_rel']:.3e}), worst leaf against its "
          f"bound: " + ", ".join(f"{g} {e:.4f} ({leaf})" for g, (e, leaf) in st["leaves"].items())
          + f" (tight {PARALLEL_TIGHT}, convs {PARALLEL_CONV}), ranks bit-identical; "
          f"calibration: {cal}; Trainer epoch on {cfg['epoch_images']} images bs{cfg['epoch_batch']} "
          f"(its eval of {cfg['epoch_test']} included): {r0['epoch_s']:.3f} s, "
          f"{cfg['epoch_images'] / r0['epoch_s']:.1f} img/s, test top-1 {h['test_acc']:.4f}, params "
          "bit-identical on both ranks")
    return r0


def serve_dp_phase(torch, dev, models, card) -> dict:
    """[serve dp]: the static convnet's engine over [cuda:0, cuda:0] against
    the one-replica engine: the DP buckets rounded as the JAX engine rounds
    them, each bucket's replay bit-equal to its eager forward and to the
    one replica's where the buckets match, one replay launching in a device
    trace twice the one replica's kernels, every served response the one
    replica's bits; trickle p50 / p99 and burst req/s of both."""
    import numpy as np

    from quantnet_torch.bench.trace import kernel_launches
    from quantnet_torch.parallel.mesh import make_mesh
    from quantnet_torch.serve import InferenceEngine

    t0 = time.perf_counter()
    m = models["convnet_static"]
    shape = (32, 32, 3)
    rng = np.random.default_rng(SEED + 7)
    loads = [("trickle", rng.integers(0, 256, (TRICKLE_REQUESTS, *shape), dtype=np.uint8)),
             ("burst", rng.integers(0, 256, (SERVE_DP_BURST, *shape), dtype=np.uint8))]
    g = torch.Generator().manual_seed(SEED + 8)
    probes = {b: torch.randint(0, 256, (b, *shape), generator=g, dtype=torch.uint8).to(dev)
              for b in (1, 2, 8, 32, 128)}
    fresh = [torch.randint(0, 256, (128, *shape), generator=g, dtype=torch.uint8).to(dev)
             for _ in range(TRACE_TRIES)]
    runs = {}
    for label, kw in (("one replica", dict(device=dev)), ("two shards", dict(mesh=make_mesh(devices=[dev, dev])))):
        with InferenceEngine(m["apply"], m["q"], m["qs"], image_shape=shape, buckets=SERVE_BUCKETS,
                             max_wait_ms=2.0, wire_dtype="uint8", normalize=(CIFAR10_MEAN, CIFAR10_STD),
                             **kw) as eng:
            replays = {}
            for b in eng.buckets:
                got = eng.replay(probes[b])
                check(torch.equal(got, eng.forward(probes[b])),
                      f"[serve dp] {label} bucket {b}: replay vs eager forward not bit-equal")
                replays[b] = got

            def same(i, out, label=label, eng=eng):
                check(torch.equal(out, eng.forward(fresh[i])), f"[serve dp] {label}: the traced "
                      f"replay (try {i + 1}) vs eager forward of its own input, not bit-equal")

            check(eng.buckets[-1] == 128, f"[serve dp] {label}: buckets {eng.buckets}")
            _, prof = _traced(lambda i: eng.replay(fresh[i]), same, [], f"[serve dp] {label}")
            runs[label] = dict(buckets=eng.buckets, replays=replays, launches=kernel_launches(prof),
                               loads=_serve_loads(eng, loads, 2.0))
    one, two = runs["one replica"], runs["two shards"]
    check(two["buckets"] == (2, 8, 32, 128), f"[serve dp] buckets {two['buckets']}")
    for b in set(one["buckets"]) & set(two["buckets"]):
        check(torch.equal(one["replays"][b], two["replays"][b]),
              f"[serve dp] bucket {b}: two shards' replay differs from one replica's")
    want = {k: 2 * v for k, v in one["launches"].items()}
    check(two["launches"] == want and any(want.values()),
          f"[serve dp] one replay launched {two['launches']}, expected {want}")
    lines = []
    for kind, imgs in loads:
        a, b = np.stack(one["loads"][kind][0]), np.stack(two["loads"][kind][0])
        check(np.array_equal(a, b), f"[serve dp] {kind}: max |diff| {float(np.abs(a - b).max())} "
              "against one replica, not bit-equal")
        for label in ("two shards", "one replica"):
            lines.append(f"{label} {_load_line(kind, len(imgs), *runs[label]['loads'][kind][1:])}")
    phase("serve dp", t0, f"{card}; static convnet u8 wire over [{dev}, {dev}], buckets "
          f"{two['buckets']}: every replay bit-equal to its eager forward and to one replica's, one "
          f"replay launching {two['launches']} (one replica {one['launches']}); every response bit-equal "
          "to one replica's; " + "; ".join(lines))
    return {"launches_per_forward": two["launches"]}


def scaling_phase(torch, dev, models, card) -> dict:
    """[scaling]: measure_scaling over the card count, the static convnet."""
    from quantnet_torch.bench.scaling import measure_scaling

    t0 = time.perf_counter()
    m = models["convnet_static"]
    res = measure_scaling(m["apply"], m["q"], m["qs"], per_device_batch=SCALING_PER_DEVICE)
    check(res["efficiency"].get(1) == 1.0 and all(v > 0 for v in res["throughput"].values()),
          f"[scaling] {res}")
    sweep = ", ".join(f"n={n}: {tp:.1f} img/s (efficiency {res['efficiency'][n]:.4f})"
                      for n, tp in sorted(res["throughput"].items()))
    phase("scaling", t0, f"{card}; static convnet, per-device batch {SCALING_PER_DEVICE} over "
          f"{torch.cuda.device_count()} card(s) ({res['device']}): {sweep}")
    return res


# ---------------------------------------------------------------------------
# The s4 runtime, the model axis and the multi-rank dry run
# ---------------------------------------------------------------------------

# [s4]: the W4A8 convnet under the s4 runtime at these batches, held
# against its int8-wide tree; weight_only_int4 at S4_WEIGHT_ONLY_BATCH.
S4_BATCHES = (BATCH, 1)
S4_WEIGHT_ONLY_BATCH = 32
# [tensor parallel]: two ranks as a (data 1 x model 2) mesh sharing the card
# over gloo; the convnet trees at TP_BATCH, one fp32 train step at
# TP_TRAIN_BATCH. W4A8's fc2 row shard folds its four groups as
# (g0 + g1) + (g2 + g3) against the one process's ((g0 + g1) + g2) + g3:
# within TP_W4A8_REL of max|logit| (the CPU test holds 1e-5 too).
TP_RANKS = 2
TP_BATCH = 1024
TP_TRAIN_BATCH = 256
TP_W4A8_REL = 1e-5
# [dryrun multichip]: dryrun_multichip(4), a (data 2 x model 2) mesh of four
# ranks on the one card; its line carries the JAX line's keys, in order
# (__graft_entry__.py:170-180), then the scaling field.
DRYRUN_DEVICES = 4
DRYRUN_KEYS = ("mesh", "loss", "int8_eval_top1", "w4a8_eval_top1", "qat_w4_step_loss",
               "qat_w4_eval_top1", "mobilenet_int8_eval_top1", "serve_reqs", "occupancy",
               "scaling_harness")
# [cli s4]: the sub-byte tiers `bench --s4-runtime` must report.
SUB_BYTE_TIERS = ("weight_only_int4", "w4a8", "qat_int4", "qat_w4a8")


def _device_bytes(torch, tree) -> int:
    """The bytes of a tree's distinct tensors on the device: QTensor
    payloads, scales and cached transposes, the GEMM constants, the rest."""
    import dataclasses

    seen = {}

    def walk(node):
        if isinstance(node, torch.Tensor):
            seen[node.data_ptr()] = max(seen.get(node.data_ptr(), 0), node.numel() * node.element_size())
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))

    walk(tree)
    return sum(seen.values())


def _four_bit_payload_bytes(tree) -> int:
    """The bytes of the 4-bit weights' payloads of a tree, on the device."""
    from quantnet_torch.core.types import QTensor
    from quantnet_torch.quantize.common import walk_layers

    total = []

    def count(path, layer):
        w = layer["w"]
        if isinstance(w, QTensor) and w.bits == 4:
            total.append(w.values.numel() * w.values.element_size())
        return layer

    walk_layers(tree, count)
    return sum(total)


def s4_phase(torch, dev, models, refined, card) -> dict:
    """[s4]: the W4A8 convnet's s4 tree at bs1024 and bs1 (logits bit-equal
    to the int8-wide tree's, every K1 launch packed; its launches are held
    against the plain version in [k1 stores]), the 4-bit payloads' device
    bytes, p50 beside the int8-wide tree's; weight_only_int4 at bs32; the
    refined W4A8 ResNet-50 of [accuracy] under the s4 runtime, every K1 and
    K3 launch held against its plain version."""
    from quantnet_torch.bench.benchmark import InferenceBenchmark
    from quantnet_torch.models import convnet, resnet
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.quantize import weight_only
    from quantnet_torch.quantize.common import s4_runtime_tree

    t0 = time.perf_counter()
    wide, s4 = models["convnet_w4a8"], models["convnet_w4a8_s4"]
    out, parts = {}, []
    for bs in S4_BATCHES:
        x = wide["x"][:bs]
        torch.cuda.synchronize()
        _zero_launch_counts()
        int8_gemm.packed_launches = 0
        got = convnet.apply(s4["q"], s4["qs"], x)[0]
        torch.cuda.synchronize()
        counts, packed = _launch_counts(), int8_gemm.packed_launches
        want = convnet.apply(wide["q"], wide["qs"], x)[0]
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"[s4] W4A8 convnet bs{bs}: s4 logits differ from the int8-wide tree's, max |diff| "
              f"{(got - want).abs().max().item()!r}")
        check(packed == counts["int8_gemm"] == 7 and counts["int8_gemm_grouped"] == 2,
              f"[s4] bs{bs}: {packed} packed K1 launches of {counts}")
        if bs == BATCH:
            out["launches"] = {"normal": packed - counts["int8_gemm_grouped"],
                               "grouped": counts["int8_gemm_grouped"]}
        bench = InferenceBenchmark(warmup=10, iters=50)
        p50 = {k: bench.measure(convnet.apply, m["q"], m["qs"], bs)["p50_ms"]
               for k, m in (("s4", s4), ("int8-wide", wide))}
        out[f"p50_bs{bs}"] = p50
        # The forward as a served request sees it: one CUDA graph of 10
        # forwards, replayed (device time, the host's cost left out).
        replay = {k: device_ms(lambda m=m: convnet.apply(m["q"], m["qs"], x), launches=10, replays=3)
                  for k, m in (("s4", s4), ("int8-wide", wide))}
        out[f"graph_ms_bs{bs}"] = replay
        parts.append(f"bs{bs}: logits bit-equal, {packed} packed K1 launches ({counts['int8_gemm_grouped']} "
                     f"grouped), p50 {p50['s4']:.4f} ms against the int8-wide tree's "
                     f"{p50['int8-wide']:.4f} ms; graph replay {replay['s4']:.4f} ms device against "
                     f"{replay['int8-wide']:.4f} ms")
    payload = {k: _four_bit_payload_bytes(m["q"]) for k, m in (("int8-wide", wide), ("s4", s4))}
    tree = {k: _device_bytes(torch, m["q"]) for k, m in (("int8-wide", wide), ("s4", s4))}
    out["payload_bytes"], out["tree_bytes"] = payload, tree
    check(2 * payload["s4"] <= payload["int8-wide"] + 16 * 7 * 512,
          f"[s4] 4-bit payloads {payload}: not halved")

    wq, wqs = weight_only.quantize(wide["params"], wide["state"], bits=4, group_size=128)
    x = wide["x"][:S4_WEIGHT_ONLY_BATCH]
    got = convnet.apply(s4_runtime_tree(wq), wqs, x)[0]
    want = convnet.apply(wq, wqs, x)[0]
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"[s4] weight_only_int4 bs{S4_WEIGHT_ONLY_BATCH}: s4 logits differ, max |diff| "
          f"{(got - want).abs().max().item()!r}")

    rq, rqs, x = refined
    want = resnet.apply(rq, rqs, x)[0]
    with held_launches(torch) as rec:
        got = resnet.apply(s4_runtime_tree(rq), rqs, x)[0]
    counts = held_counts(rec)
    wides = [k for k, c in rec["calls"]["int8_gemm"].items() if c[2].dtype != torch.uint8]
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"[s4] refined W4A8 ResNet-50: s4 logits differ, max |diff| {(got - want).abs().max().item()!r}")
    check(counts["int8_gemm"] == 53 and counts["residual_boundary"] == 15 and not wides,
          f"[s4] refined W4A8 ResNet-50: launches {counts}, int8-wide K1 calls {wides}")
    out["resnet50_launches"] = counts
    phase("s4", t0, f"{card}; W4A8 convnet: " + "; ".join(parts) + f"; 4-bit payloads on the device "
          f"{payload['int8-wide']} bytes int8-wide, {payload['s4']} packed (the tree with its GEMM "
          f"constants {tree['int8-wide']} and {tree['s4']}); weight_only_int4 bs{S4_WEIGHT_ONLY_BATCH} "
          f"logits bit-equal; refined W4A8 ResNet-50 bs{RESNET_BATCH}: logits bit-equal, "
          f"{counts['int8_gemm']} K1 launches, all packed ({counts['int8_gemm_grouped']} grouped), "
          f"and {counts['residual_boundary']} K3, each bit-equal to its plain version")
    return out


def _tp_rank(rank: int, world: int, port: int) -> dict:
    """One rank of [tensor parallel]: the convnet's static, dynamic (K2 at
    fc1's column shard, the row-shard route at fc2; and the per-row route)
    and W4A8 trees sharded over the model axis against this process's
    unsharded forward; one fp32 train step against one process's (rank 0)."""
    import hashlib

    from quantnet_torch.core.config import Flags, TrainConfig
    from quantnet_torch.entry import static_entry
    from quantnet_torch.models import convnet
    from quantnet_torch.ops import linear as ops_linear
    from quantnet_torch.ops.int8_matmul import int8_gemm
    from quantnet_torch.parallel import mesh as meshlib
    from quantnet_torch.parallel import steps, tensor
    from quantnet_torch.quantize import dynamic, fold, static
    from quantnet_torch.train import trainer as tr

    import torch

    dev = meshlib.init_distributed(f"127.0.0.1:{port}", world, rank, device="cuda")
    mesh = meshlib.make_mesh(1, world)
    out = {"backend": mesh.backend, "device": str(dev), "shape": mesh.shape, "forwards": {}}
    _, (sq, sqs, x) = static_entry(dev, batch_size=TP_BATCH, calibration_size=RESNET_CALIBRATION,
                                   seed=SEED)
    params, state = convnet.init(torch.Generator().manual_seed(SEED), device=dev)
    dq, dqs = dynamic.quantize(params, state)
    fparams, fstate = fold.fold_model(params, state)
    calib = torch.randn((RESNET_CALIBRATION, 32, 32, 3),
                        generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    act = static.calibrate(convnet.apply, fparams, fstate, [calib], cross_process=False)
    wq, wqs = static.bake(fparams, fstate, act, skip_first_layer=True, weight_bits=4,
                          weight_group_size=W4A8_GROUP)
    per_row = Flags(dynamic_linear="unfused")
    epilogues = []
    row_epilogue, all_reduce, all_gather = ops_linear.row_epilogue, tensor.all_reduce, meshlib.all_gather

    def captured(acc, epi):
        epilogues.append((acc, epi))
        return row_epilogue(acc, epi)

    def synced(fn):
        """A collective that first waits for the card, so that its host
        time is the collective's own and not the forward's before it."""
        def call(*args, **kw):
            _sync(torch, dev)
            return fn(*args, **kw)
        return call

    def timed(fn):
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(torch, dev)
        return out, (time.perf_counter() - t0) * 1e3

    for name, q, qs, flags in (("static", sq, sqs, Flags()), ("dynamic", dq, dqs, Flags()),
                               ("dynamic_per_row", dq, dqs, per_row), ("w4a8", wq, wqs, Flags())):
        sharded = tensor.shard_params(mesh, q, model_parallel=True)
        st = tensor.shard_params(mesh, qs, model_parallel=True)
        convnet.apply(sharded, st, x, flags=flags)  # warm-up, both
        want, one_ms = timed(lambda: convnet.apply(q, qs, x, flags=flags)[0])
        want, one_ms = timed(lambda: convnet.apply(q, qs, x, flags=flags)[0])
        _zero_launch_counts()
        ops_linear.row_epilogue = captured
        try:
            got, wall_ms = timed(lambda: convnet.apply(sharded, st, x, flags=flags)[0])
        finally:
            ops_linear.row_epilogue = row_epilogue
        launches = _launch_counts()
        # Again with each collective waiting for the card first: their own time.
        c0 = meshlib.collective_seconds[0]
        tensor.all_reduce, meshlib.all_gather = synced(all_reduce), synced(all_gather)
        try:
            timed(lambda: convnet.apply(sharded, st, x, flags=flags))
        finally:
            tensor.all_reduce, meshlib.all_gather = all_reduce, all_gather
        coll = meshlib.collective_seconds[0] - c0
        # The K2 row route folds its blocks itself; the others end in row_epilogue.
        epilogue_ms = time_ms(lambda: row_epilogue(*epilogues[-1])) if epilogues else None
        out["forwards"][name] = dict(
            bit_equal=torch.equal(got.view(torch.int32), want.view(torch.int32)),
            rel=((got - want).abs().max() / want.abs().max()).item(), launches=launches,
            collective_ms=coll * 1e3, wall_ms=wall_ms, one_wall_ms=one_ms,
            epilogue_ms=epilogue_ms, finite=bool(torch.isfinite(got).all()))
        epilogues.clear()

    # One fp32 train step at the global batch (the data axis is 1: every
    # rank holds every row), against one process's on rank 0.
    g = torch.Generator().manual_seed(SEED + 5)
    images = torch.randn((TP_TRAIN_BATCH, 32, 32, 3), generator=g).to(dev)
    labels = torch.randint(0, 10, (TP_TRAIN_BATCH,), generator=g).to(dev)
    cfg = TrainConfig(epochs=1, batch_size=TP_TRAIN_BATCH, lr=0.1)

    def step(m):
        opt = tr.Optimizer(cfg, 10)
        p = tr.clone_tree(params if m is None else tensor.shard_params(m, params, model_parallel=True),
                          requires_grad=True)
        s = state if m is None else tensor.shard_params(m, state, model_parallel=True)
        leaves = tr.tensor_leaves(p)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        kw = dict(augment=True, rotation_deg=15.0, color_jitter=0.2)
        if m is None:
            ns, loss, _ = tr.train_step(convnet.apply, opt, p, s, opt.init(leaves), leaves, gen,
                                        images, labels, **kw)
            return tr.clone_tree(p), ns, float(loss), None
        ns, loss, _ = steps.train_step(m, convnet.apply, opt, p, s, opt.init(leaves), leaves, gen,
                                       images, labels, **kw)
        rep = [t for t, sp in zip(leaves, tensor.sharded_leaves(p, True)) if not sp]
        digest = hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes() for t in rep)).hexdigest()
        return (tr.clone_tree(tensor.gather_params(m, p)), tensor.gather_params(m, ns), float(loss),
                digest)

    tp = step(mesh)
    digests = meshlib.gather_objects(tp[3])
    if rank == 0:
        sp = step(None)
        out["step"] = dict(
            ranks_identical=len(set(digests)) == 1, loss=tp[2], loss_one=sp[2],
            loss_rel=abs(tp[2] - sp[2]) / abs(sp[2]),
            leaves=_leaf_excess(torch, {"p": tp[0], "s": tp[1]}, {"p": sp[0], "s": sp[1]},
                                _parallel_bounds))
    torch.distributed.destroy_process_group()
    return out


def _spawn_ranks(torch, label: str, target, world: int) -> dict:
    """`world` spawned ranks running target(rank, world, port); a failed
    rank, or one that outlives PARALLEL_TIMEOUT_S, fails the phase. Returns
    {rank: result}."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_parallel_worker, args=(r, world, port, results, target))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        while len(got) < world:
            try:
                rank, ok, payload = results.get(timeout=max(deadline - time.monotonic(), 1.0))
            except queue.Empty:
                raise SmokeFailure(f"[{label}] no result from ranks "
                                   f"{sorted(set(range(world)) - set(got))} in "
                                   f"{PARALLEL_TIMEOUT_S} s") from None
            check(ok, f"[{label}] rank {rank} failed:\n{payload}")
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    check(all(p.exitcode == 0 for p in procs), f"[{label}] exit codes {[p.exitcode for p in procs]}")
    return got


def tensor_parallel_phase(torch, card) -> dict:
    """[tensor parallel]: two spawned ranks as a (data 1 x model 2) mesh,
    sharing the card over gloo (the backend printed): the static and
    dynamic convnet's sharded logits bit-equal to one process's (K1 and K2
    launched on each rank), W4A8 within TP_W4A8_REL; the host time of the
    all-reduces and of the row shard's epilogue per forward; one fp32 train
    step at bs256 within [parallel]'s bounds of one process's, the
    replicated leaves bit-identical on both ranks."""
    t0 = time.perf_counter()
    got = _spawn_ranks(torch, "tensor parallel", _tp_rank, TP_RANKS)
    r0 = got[0]
    check(all(r["backend"] == "gloo" and r["shape"] == {"data": 1, "model": TP_RANKS}
              for r in got.values()), f"[tensor parallel] meshes {[(r['backend'], r['shape']) for r in got.values()]}")
    for rank, r in got.items():
        for name, f in r["forwards"].items():
            check(f["finite"], f"[tensor parallel] rank {rank} {name}: non-finite logits")
            if name == "w4a8":
                check(f["rel"] <= TP_W4A8_REL, f"[tensor parallel] rank {rank} w4a8: max |diff| "
                      f"{f['rel']:.3e} x max|logit| > {TP_W4A8_REL}")
            else:
                check(f["bit_equal"], f"[tensor parallel] rank {rank} {name}: not bit-equal to one "
                      f"process's (max |diff| {f['rel']:.3e} x max|logit|)")
            k1 = f["launches"]["int8_gemm"]
            check(k1 > 0 and (name != "dynamic" or f["launches"]["fused_dynamic_gemm"] == 1),
                  f"[tensor parallel] rank {rank} {name}: launches {f['launches']}")
    st = r0["step"]
    check(st["ranks_identical"], "[tensor parallel] the replicated leaves differ between the ranks")
    check(st["loss_rel"] <= PARALLEL_LOSS_REL, f"[tensor parallel] step loss {st['loss']} against one "
          f"process's {st['loss_one']}: rel {st['loss_rel']:.3e} > {PARALLEL_LOSS_REL}")
    for group, (excess, leaf) in st["leaves"].items():
        check(excess <= 1.0, f"[tensor parallel] {group}: {leaf} at {excess:.3f}x its bound")
    def forward_line(name, f):
        held = "bit-equal" if f["bit_equal"] else f"max |diff| {f['rel']:.3e} x max|logit|"
        launches = {k: v for k, v in f["launches"].items() if v}
        epi = ("the K2 route's own block fold" if f["epilogue_ms"] is None
               else f"row epilogue {f['epilogue_ms']:.4f} ms")
        return (f"{name} {held}, launches {launches} per rank, a sharded forward {f['wall_ms']:.3f} ms "
                f"(one process {f['one_wall_ms']:.3f} ms), its collectives {f['collective_ms']:.3f} ms "
                f"of host time (each after a sync), {epi}")

    fw = "; ".join(forward_line(n, f) for n, f in r0["forwards"].items())
    phase("tensor parallel", t0, f"{card}; {TP_RANKS} ranks on {r0['device']} as a 1x{TP_RANKS} mesh, "
          f"backend {r0['backend']} (ranks share a card); convnet bs{TP_BATCH}, fc1 by columns and fc2 "
          f"by rows: {fw}; fp32 train step bs{TP_TRAIN_BATCH} (aug + dropout) loss {st['loss']!r} "
          f"against one process's {st['loss_one']!r} (rel {st['loss_rel']:.3e}), worst leaf against its "
          f"bound: " + ", ".join(f"{g} {e:.4f} ({leaf})" for g, (e, leaf) in st["leaves"].items())
          + "; replicated leaves bit-identical on both ranks")
    return r0


def dryrun_phase(torch, card) -> dict:
    """[dryrun multichip]: quantnet_torch.entry.dryrun_multichip(4) on the
    one card, its line checked: every key of the JAX line, every request
    served, the losses finite, the replicated leaves bit-identical on all
    ranks."""
    import re

    from quantnet_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    r = dryrun_multichip(DRYRUN_DEVICES)
    line = r["line"]
    keys = tuple(re.findall(r"(\w+)=", line))
    check(keys == DRYRUN_KEYS, f"[dryrun multichip] keys {keys}")
    check(r["mesh"] == {"data": DRYRUN_DEVICES // 2, "model": 2}, f"[dryrun multichip] mesh {r['mesh']}")
    check("serve_reqs=200/200" in line, f"[dryrun multichip] {line}")
    check(math.isfinite(r["loss"]) and math.isfinite(r["qat_loss"]), f"[dryrun multichip] losses {line}")
    check(len(set(r["replicated_digests"])) == 1 and len(r["replicated_digests"]) == DRYRUN_DEVICES,
          "[dryrun multichip] the replicated leaves differ between ranks")
    phase("dryrun multichip", t0, f"{card}; {line}")
    return r


def cli_experiment_phase(torch, card) -> None:
    """[cli experiment]: python -m quantnet_torch experiment --epochs 1
    --qat-epochs 1 in an empty directory under build/ on 2048 synthetic
    images: the report's markdown and CSV list every scheme, a second
    report writes the same bytes; then scaling."""
    import pathlib
    import tempfile

    from quantnet_torch.cli.main import main as cli

    t0 = time.perf_counter()
    root = pathlib.Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    files = ("quantization_comparison.csv", "quantization_comparison.json", "detailed_analysis_report.md")
    with tempfile.TemporaryDirectory(dir=root / "build") as d:
        args = ["--save-dir", f"{d}/saved", "--results-dir", f"{d}/results", "--data-dir", f"{d}/data",
                "--synthetic-train-size", "2048", "--synthetic-test-size", "2560"]
        out = cli(["experiment", "--epochs", "1", "--qat-epochs", "1", "--batch-sizes", "1,32", "--warmup",
                   "3", "--iters", "20", *args])
        res = pathlib.Path(d) / "results"
        md = (res / "detailed_analysis_report.md").read_text()
        rows = [ln.split(" | ")[0][2:] for ln in md.splitlines()
                if ln.startswith("| ") and not ln.startswith("| model")]
        csv_rows = [ln.split(",")[0] for ln in (res / "quantization_comparison.csv").read_text().splitlines()[1:]]
        check(rows == csv_rows == list(EXPERIMENT_SCHEMES), f"[cli experiment] report rows {rows}, csv {csv_rows}")
        before = {f: (res / f).read_bytes() for f in files}
        t1 = time.perf_counter()
        cli(["report", *args])
        check({f: (res / f).read_bytes() for f in files} == before,
              "[cli experiment] a second report wrote other bytes")
        report_s = time.perf_counter() - t1
        sc = cli(["scaling", "--per-device-batch", str(SCALING_PER_DEVICE), *args])
        written = json.loads((res / "scaling.json").read_text())
        check(set(written) == {"model", "throughput", "efficiency"} and written["model"] == "static",
              f"[cli experiment] scaling.json {written}")
        acc, bench = out["accuracy"], out["benchmark"]
        phase("cli experiment", t0, f"{card}; train (1 epoch, 2048 images) -> quantize all -> qat (1 "
              f"epoch) -> evaluate -> bench -> report: top-1 fp32 {acc['fp32']['top1']:.4f}, static "
              f"{acc['static']['top1']:.4f}, qat {acc['qat']['top1']:.4f}; static bs32 "
              f"{bench['static']['bs32']['images_per_s']:.1f} img/s; the report lists the "
              f"{len(EXPERIMENT_SCHEMES)} artifacts and a second report ({report_s:.2f} s) wrote the "
              f"same bytes; scaling {sc['throughput'][1]:.1f} img/s at n=1")

        # [cli s4]: the sub-byte QAT tiers on the experiment's artifacts, then
        # bench over every artifact, int8-wide and with --s4-runtime, in turn.
        t2 = time.perf_counter()
        cli(["qat", "--epochs", "1", "--weight-bits", "4", "--init-from", "w4a8", *args])
        cli(["qat", "--epochs", "1", "--weight-bits", "4", "--weight-only", "--init-from",
             "weight_only_int4", *args])
        bench_args = ["--batch-sizes", "1,32", "--warmup", "3", "--iters", "20", *args]
        wide = cli(["bench", *bench_args])
        s4 = cli(["bench", "--s4-runtime", *bench_args])
        rows = json.loads((res / "benchmark.json").read_text())
        check(all(t in rows and t in s4 for t in SUB_BYTE_TIERS),
              f"[cli s4] benchmark.json rows {sorted(rows)}")
        tiers = "; ".join(
            f"{t} p50 bs1 {s4[t]['bs1']['p50_ms']:.4f} ms, bs32 {s4[t]['bs32']['p50_ms']:.4f} ms "
            f"(int8-wide {wide[t]['bs1']['p50_ms']:.4f}, {wide[t]['bs32']['p50_ms']:.4f})"
            for t in SUB_BYTE_TIERS)
        phase("cli s4", t2, f"{card}; qat --weight-bits 4 --init-from w4a8 -> qat_w4a8, qat --weight-bits "
              f"4 --weight-only --init-from weight_only_int4 -> qat_int4, bench then bench --s4-runtime: "
              f"{len(rows)} rows in benchmark.json; {tiers}")


# [cli imagenet]: each artifact's launches of one bs128 forward, as the
# wrappers count them. static: K1 at the int8 7x7 stem, the 52 convs and the
# fc, K3 at the 15 block boundaries; dynamic: K1 at the stem and the 52
# convs, K2 at the fc, no K3 (its identities stay f32); W4A8: K1 at the stem
# and the 52 convs and its grouped-K mode at the fc (counted among K1's too).
IMAGENET_LAUNCHES = {
    "static": {"int8_gemm": 54, "int8_gemm_grouped": 0, "fused_dynamic_gemm": 0,
               "residual_boundary": 15, "depthwise_conv": 0},
    "dynamic": {"int8_gemm": 53, "int8_gemm_grouped": 0, "fused_dynamic_gemm": 1,
                "residual_boundary": 0, "depthwise_conv": 0},
    "w4a8": {"int8_gemm": 54, "int8_gemm_grouped": 1, "fused_dynamic_gemm": 0,
             "residual_boundary": 15, "depthwise_conv": 0},
}

# [cli imagenet]: the ImageFolder written when PIL imports, (height, width)
# of each class's JPEGs.
IMAGENET_FILES = [[(375, 500), (500, 333), (240, 240)], [(180, 260), (600, 400), (224, 300)]]


def _imagenet_folder(root) -> int:
    """<root>/imagenet/val/<wnid>/*.JPEG of seeded random pixels; the count."""
    import numpy as np
    from PIL import Image

    r = np.random.default_rng(0)
    n = 0
    for ci, files in enumerate(IMAGENET_FILES):
        cdir = root / "imagenet" / "val" / f"n{ci:08d}"
        cdir.mkdir(parents=True)
        for h, w in files:
            pixels = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
            Image.fromarray(pixels).save(cdir / f"ILSVRC2012_val_{n:08d}.JPEG", quality=90)
            n += 1
    return n


def cli_imagenet_phase(torch, dev, card, resnet_stats) -> dict:
    """[cli imagenet]: the ImageNet track through python -m quantnet_torch in
    process. --dataset imagenet resolves to ResNet-50 at 224x224 with 1000
    classes; experiment --importance static_map on the synthetic split (256 /
    256 images) into a temporary directory under build/; the static
    artifact's forward at bs128 with every count set to 0 just before it (54
    K1: the experiment bakes the 7x7 stem int8, as the JAX CLI does without
    --skip-first-layer; 15 K3), then under held_launches, then its plain run, bit for bit;
    the dynamic and W4A8 artifacts' K1, K2 and grouped-K1 launches counted
    and held the same way; the experiment's optimized tree against quantize
    --scheme optimized --importance static_map on a copy of its fp32
    artifact, leaf for leaf; and the real-data branch: evaluate on a tiny
    ImageFolder where PIL imports, else the loader naming PIL."""
    import pathlib
    import shutil
    import tempfile

    import numpy as np

    from quantnet_torch.cli.main import _resolve_defaults, build_parser
    from quantnet_torch.cli.main import main as cli
    from quantnet_torch.core.config import Flags
    from quantnet_torch.data import datasets
    from quantnet_torch.models import resnet
    from quantnet_torch.train.checkpoint import load_artifact

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    args = build_parser().parse_args(["experiment", "--dataset", "imagenet"])
    _resolve_defaults(args)
    resolved = (args.model, args.image_size, args.num_classes)
    check(resolved == ("resnet50", 224, 1000), f"[cli imagenet] --dataset imagenet resolved to {resolved}")
    root = pathlib.Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as d:
        data = ["--dataset", "imagenet", "--data-dir", f"{d}/data", "--synthetic-train-size", "256",
                "--synthetic-test-size", "256", "--calibration-batches", "2"]
        dirs = ["--save-dir", f"{d}/saved", "--results-dir", f"{d}/results"]
        t1 = time.perf_counter()
        out = cli(["experiment", "--importance", "static_map", "--epochs", "1", "--qat-epochs", "1",
                   "--batch-sizes", "1,128", "--warmup", "5", "--iters", "20", *data, *dirs])
        experiment_s = time.perf_counter() - t1
        acc, bench = out["accuracy"], out["benchmark"]
        check(list(acc) == list(EXPERIMENT_SCHEMES) and all(r["n"] == 256 for r in acc.values()),
              f"[cli imagenet] evaluated {[(k, r['n']) for k, r in acc.items()]}")
        md = (pathlib.Path(d) / "results" / "detailed_analysis_report.md").read_text()
        rows = [ln.split(" | ")[0][2:] for ln in md.splitlines()
                if ln.startswith("| ") and not ln.startswith("| model")]
        check(rows == list(EXPERIMENT_SCHEMES), f"[cli imagenet] report rows {rows}")

        # The static artifact at bs128 on the split's first images.
        _, test = datasets.load_imagenet(f"{d}/data", image_size=224, synthetic_train_size=256,
                                         synthetic_test_size=256, num_classes=1000)
        x = torch.from_numpy(test.take(np.arange(RESNET_BATCH))).to(dev)
        trees = {name: load_artifact(f"{d}/saved/{name}", device=dev)[0] for name in IMAGENET_LAUNCHES}
        launches, held, logits = {}, {}, {}
        for name, tree in trees.items():
            torch.cuda.synchronize()
            _zero_launch_counts()
            logits[name], _ = resnet.apply(tree["params"], tree["state"], x)
            torch.cuda.synchronize()
            launches[name] = _launch_counts()
            with held_launches(torch) as rec:
                again, _ = resnet.apply(tree["params"], tree["state"], x)
            held[name] = held_counts(rec)
            check(all(held[name][k] == launches[name][k] for k in held[name]),
                  f"[cli imagenet] {name}: held launches {held[name]}, counted {launches[name]}")
            check(torch.equal(again.view(torch.int32), logits[name].view(torch.int32)),
                  f"[cli imagenet] {name}: the held forward's logits differ")
            check(launches[name] == IMAGENET_LAUNCHES[name], f"[cli imagenet] {name} ResNet-50 "
                  f"launches {launches[name]}, expected {IMAGENET_LAUNCHES[name]}")
        static = launches["static"]
        st = trees["static"]
        ref, _ = resnet.apply(st["params"], st["state"], x, flags=Flags(plain=True))
        lg = logits["static"]
        check(tuple(lg.shape) == (RESNET_BATCH, 1000) and bool(torch.isfinite(lg).all()),
              f"[cli imagenet] static logits {tuple(lg.shape)}")
        check(torch.equal(lg.view(torch.int32), ref.view(torch.int32)),
              f"[cli imagenet] static vs its plain run: max |diff| {(lg - ref).abs().max().item()!r}")

        # Queue 3 item 17 on the card: the experiment's optimized tree is
        # quantize --scheme optimized --importance static_map's.
        q = pathlib.Path(d) / "quantize" / "saved"
        q.mkdir(parents=True)
        for suffix in (".json", ".npz"):
            shutil.copy(pathlib.Path(d) / "saved" / f"fp32{suffix}", q)
        cli(["quantize", "--scheme", "optimized", "--importance", "static_map", *data,
             "--save-dir", str(q), "--results-dir", f"{d}/quantize/results"])
        a, b = pathlib.Path(d) / "saved" / "optimized", q / "optimized"
        with np.load(f"{a}.npz") as za, np.load(f"{b}.npz") as zb:
            check(sorted(za.files) == sorted(zb.files) and len(za.files) > 0,
                  "[cli imagenet] optimized trees hold other leaves")
            differ = [k for k in za.files if za[k].dtype != zb[k].dtype or not np.array_equal(za[k], zb[k])]
            n_leaves = len(za.files)
        check(not differ, f"[cli imagenet] optimized leaves differ from quantize --importance "
              f"static_map's: {differ[:5]}")
        meta_a, meta_b = (json.loads(p.with_suffix(".json").read_text())["metadata"] for p in (a, b))
        check(meta_a == meta_b, "[cli imagenet] optimized metadata differ")
        tiers = sorted(set(meta_a["policy"].values()))

        # The real-data branch.
        real = pathlib.Path(d) / "real"
        try:
            import PIL  # noqa: F401
            pil = True
        except ImportError:
            pil = False
        if pil:
            n = _imagenet_folder(real)
            ev = cli(["evaluate", "--models", "static", "--dataset", "imagenet", "--data-dir", str(real),
                      "--save-dir", f"{d}/saved", "--results-dir", f"{d}/real_results"])
            split = datasets.load_imagenet(str(real), image_size=224)[1]
            check(split.raw_u8 is not None and split.images is None and len(split) == n
                  and split.num_classes == len(IMAGENET_FILES),
                  f"[cli imagenet] the decoded split: {split.name}, {len(split)} images, u8 "
                  f"{split.raw_u8 is not None}")
            lg_real, _ = resnet.apply(st["params"], st["state"],
                                      torch.from_numpy(split.take(np.arange(n))).to(dev))
            _, top1, top5 = _host_counts([lg_real], split.labels)
            r = ev["static"]
            check(r["n"] == n and r["top1"] == top1 / n and r["top5"] == top5 / n,
                  f"[cli imagenet] evaluator top-1 {r['top1']} / top-5 {r['top5']} over {r['n']}, the "
                  f"host counts {top1} / {top5} of {n}")
            branch = (f"real data: PIL {PIL.__version__}, evaluate --dataset imagenet on {n} decoded "
                      f"JPEGs ({len(IMAGENET_FILES)} classes, u8-resident), counts equal the host's")
        else:
            (real / "imagenet" / "val" / "n00000000").mkdir(parents=True)
            (real / "imagenet" / "val" / "n00000000" / "x.JPEG").write_bytes(b"")
            try:
                datasets.load_imagenet(str(real), image_size=224)
                raised = None
            except ModuleNotFoundError as e:
                raised = e
            check(raised is not None and "PIL" in str(raised),
                  f"[cli imagenet] a present val directory without PIL: {raised!r}")
            branch = f"real data: no PIL; a present val directory raises {raised}"

    s = bench["static"][f"bs{RESNET_BATCH}"]
    rb = (f"{resnet_stats['p50_ms']:.4f} ms, {resnet_stats['images_per_s_p50']:.1f} img/s"
          if resnet_stats else "not run")
    dyn, w4 = held["dynamic"], held["w4a8"]
    phase("cli imagenet", t0, f"{card}; --dataset imagenet -> {resolved}; experiment --importance "
          f"static_map (ResNet-50 224x224, 1000 classes, 256 / 256 synthetic images) in "
          f"{experiment_s:.2f} s, {len(acc)} artifacts evaluated, report written; static bs"
          f"{RESNET_BATCH}: K1 {static['int8_gemm']} and K3 {static['residual_boundary']} launches, "
          f"each bit-equal to its plain version, logits bit-equal to the plain run; dynamic K1 "
          f"{dyn['int8_gemm']}, K2 {dyn['fused_dynamic_gemm']}, K3 {dyn['residual_boundary']}; w4a8 "
          f"K1 {w4['int8_gemm']} (grouped {w4['int8_gemm_grouped']}), K3 {w4['residual_boundary']}, "
          f"all held bit-equal; optimized ({n_leaves} leaves, tiers {tiers}) equal to quantize "
          f"--importance static_map's; {branch}; static bs{RESNET_BATCH} p50 {s['p50_ms']:.4f} ms, "
          f"{s['images_per_s_p50']:.1f} img/s (experiment's bench) beside [resnet50 bench] {rb}")
    return launches


def main() -> int:
    import torch

    name, card = device_phase(torch)
    dev = torch.device("cuda", 0)
    build_phase()
    int8_err = int8_gemm_phase(torch, dev)
    dw_err = depthwise_phase(torch, dev)
    models = build_models(torch, dev)
    k1_calls, dw_calls, store_errs = k1_stores_phase(torch, models)
    fused_err = fused_phase(torch, dev)
    boundary_err = boundary_phase(torch, dev)
    k1_int32, k1, k1g, k2, k3, k4, k1p, plans = times_phase(torch, dev, k1_calls, dw_calls, models)
    del k1_calls, dw_calls
    convnet_launches = main_path_phase(torch, dev, models["convnet"])
    static_launches = static_phase(torch, dev, models["convnet_static"])
    resnet_launches = resnet_phase(torch, dev, models["resnet50"])
    w4a8_launches = w4a8_phase(torch, models["convnet_w4a8"])
    mnv2_launches = mobilenet_phase(torch, models)
    s2d_phase(torch, models)
    schemes_phase(torch, dev, models)
    bench_torch_phase()
    serving = serve_phase(torch, dev, models)
    observers_phase(torch, dev, models["resnet50"])
    accuracy = accuracy_phase(torch, dev, models)
    s4 = s4_phase(torch, dev, models, accuracy.pop("refined_tree"), card)
    cli_phase(torch)
    train_phase(torch, dev, card)
    qat = qat_phase(torch, dev, card)
    cli_train_phase(torch)
    parallel = parallel_phase(torch, card)
    tp = tensor_parallel_phase(torch, card)
    dryrun_phase(torch, card)
    serve_dp = serve_dp_phase(torch, dev, models, card)
    scaling_phase(torch, dev, models, card)
    cli_experiment_phase(torch, card)
    imagenet = cli_imagenet_phase(torch, dev, card, models["resnet50"].get("bench_stats"))

    def entry(kname, path, source, replaces, launches, err, sums, library):
        return {
            "name": kname, "path": path, "route": "cuda",
            "source": f"quantnet_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            "ms": sums["ms"], "plain_ms": sums["plain_ms"], "bound_ms": sums["bound_ms"],
            "bound_by": bound_by(sums), "library_ms": library,
        }

    def with_engine(e, path):
        """Launches through the serving engine, counted in device traces:
        per forward (one replay of the largest bucket's graph) and over the
        traced run of the [serve] loads."""
        e.update(engine_launches_per_forward=serving[path]["launches_per_forward"][e["name"]],
                 serve_launches=serving[path]["launches"][e["name"]])
        return e

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

    def grouped_entry(launches):
        """K1's grouped-K mode (W4A8's dense layers) as the W4A8 convnet
        launches it (fc1 and fc2, g128). No PyTorch call computes it:
        unfused_ms is the route it replaces, one int32 launch of K1 per
        group and the combine in PyTorch ops."""
        sums, one = k1g["bs1024"], k1g["bs1"]
        e = entry("int8_gemm_grouped", "convnet_w4a8", "int8_gemm.cu",
                  "quantnet/ops/pallas_matmul.py:54 (grouped-K mode for quantnet/ops/linear.py:228-253)",
                  launches, max(int8_err["grouped"], store_errs["convnet_w4a8"]["k1"]), sums, None)
        e.update(unfused_ms=sums["library_ms"], back_to_back_ms=sums["back_to_back_ms"],
                 bs1_ms=one["ms"], bs1_bound_ms=one["bound_ms"], bs1_plain_ms=one["plain_ms"],
                 bs1_back_to_back_ms=one["back_to_back_ms"], plans=plans["grouped"])
        return e

    def k4_entry(launches):
        """K4 as the static MobileNetV2 launches it (17 depthwise convs with
        the int8 handoff and relu6), in device time (back_to_back_ms: the
        same calls between CUDA events, host cost included), its int32 store
        beside one F.conv2d of the values in f32 NCHW (groups = C, TF32 off;
        library_ms) and in f32 and bf16 channels_last; and as the dynamic
        MobileNetV2 launches it (the bf16 store)."""
        e = entry("depthwise_conv", "mobilenetv2", "depthwise_conv.cu",
                  "none: XLA's native grouped conv (quantnet/ops/conv.py:123-128)", launches,
                  max(dw_err, store_errs["mobilenetv2"]["k4"], store_errs["mobilenetv2_dynamic"]["k4"]),
                  k4, k4["library_ms"])
        e.update({key: v for key, v in k4.items() if key not in _sums()})
        return e

    def packed_entry(kind):
        """K1's packed-B mode (the s4 runtime) as the W4A8 convnet's s4 tree
        launches it at bs1024, normal at the convs and grouped at fc1 and
        fc2; the bound counts the packed weight's bytes. No PyTorch call
        computes it: int8_wide_ms is the same launch on the widened weight.
        The bs1 figures beside them (the first row of each call)."""
        sums, one = k1p[kind], k1p[f"{kind}_bs1"]
        name = "int8_gemm_packed" + ("_grouped" if kind == "grouped" else "")
        e = entry(name, "convnet_w4a8_s4", "int8_gemm.cu",
                  "quantnet/ops/pallas_matmul.py:54 (packed-B mode: the s4 runtime's 4-bit weights, "
                  "quantnet/quantize/common.py:90-113)", s4["launches"][kind],
                  store_errs["convnet_w4a8_s4"]["k1"], sums, None)
        e.update(int8_wide_ms=sums["library_ms"], bs1_ms=one["ms"], bs1_bound_ms=one["bound_ms"],
                 bs1_plain_ms=one["plain_ms"], bs1_int8_wide_ms=one["library_ms"],
                 back_to_back_ms=sums["back_to_back_ms"],
                 int8_wide_back_to_back_ms=sums["wide_back_to_back_ms"],
                 bs1_back_to_back_ms=one["back_to_back_ms"],
                 bs1_int8_wide_back_to_back_ms=one["wide_back_to_back_ms"],
                 plans=plans["packed_" + kind],
                 s4_forward_graph_ms={f"bs{bs}": s4[f"graph_ms_bs{bs}"] for bs in S4_BATCHES},
                 s4_forward_p50_ms={f"bs{bs}": s4[f"p50_bs{bs}"] for bs in S4_BATCHES})
        return e

    int8_err["mobilenetv2"] = store_errs["mobilenetv2"]["k1"]
    # One entry per (kernel, path): K1 runs on four paths, at other shapes,
    # so each path's launches, times and bound stay comparable across runs.
    kernels = [with_engine(e, e["path"]) for e in (
        k1_entry("convnet", convnet_launches["int8_gemm"]),
        k1_entry("convnet_static", static_launches["int8_gemm"]),
        k1_entry("resnet50", resnet_launches["int8_gemm"]),
        k1_entry("mobilenetv2", mnv2_launches["mobilenetv2"]["int8_gemm"]),
        k2_entry(convnet_launches["fused_dynamic_gemm"]),
        entry("residual_boundary", "resnet50", "residual_boundary.cu",
              "quantnet/ops/pallas_boundary.py:85", resnet_launches["residual_boundary"],
              boundary_err, k3, None),
        k4_entry(mnv2_launches["mobilenetv2"]["depthwise_conv"]),
    )] + [grouped_entry(w4a8_launches["int8_gemm_grouped"]), packed_entry("normal"),
          packed_entry("grouped")]
    # The [accuracy] paths' launches, beside the entries whose kernels they
    # drive: MobileNetV2's sensitivity sweep (K1, K2, K4) and the refined
    # W4A8 ResNet-50's forward (K1, its grouped-K mode, K3).
    swept = {("int8_gemm", "mobilenetv2"), ("fused_dynamic_gemm", "convnet"),
             ("depthwise_conv", "mobilenetv2")}
    refined = {("int8_gemm", "resnet50"), ("residual_boundary", "resnet50"),
               ("int8_gemm_grouped", "convnet_w4a8")}
    # The baked QAT trees' launches ([qat], each forward's wrapper counts):
    # the convnet's int8 stores, qat_w4a8's grouped-K mode, ResNet-50's and
    # MobileNetV2's K1 with K3 and K4.
    qat_trees = {("int8_gemm", "convnet_static"): ("convnet", "int8_gemm"),
                 ("int8_gemm", "resnet50"): ("resnet50", "int8_gemm"),
                 ("int8_gemm", "mobilenetv2"): ("mobilenetv2", "int8_gemm"),
                 ("residual_boundary", "resnet50"): ("resnet50", "residual_boundary"),
                 ("depthwise_conv", "mobilenetv2"): ("mobilenetv2", "depthwise_conv"),
                 ("int8_gemm_grouped", "convnet_w4a8"): ("convnet_w4a8", "int8_gemm_grouped")}
    # [cli imagenet]'s launches by model and artifact (the static, dynamic
    # and W4A8 ResNet-50 at bs128), beside the entries whose kernels they
    # drive.
    imagenet_paths = {("int8_gemm", "resnet50"), ("residual_boundary", "resnet50"),
                      ("fused_dynamic_gemm", "convnet"), ("int8_gemm_grouped", "convnet_w4a8")}
    # The data-parallel paths' K1 launches on the static convnet: rank 0's
    # sharded eval and its calibrated (min-max) forward in [parallel], and
    # one replay of the two-shard engine in [serve dp] (a device trace).
    for e in kernels:
        if (e["name"], e["path"]) == ("int8_gemm", "convnet_static"):
            e.update(tensor_parallel_launches_per_rank=tp["forwards"]["static"]["launches"]["int8_gemm"])
            e.update(parallel_eval_launches=parallel["eval_launches"],
                     parallel_calibrated_launches=parallel["calibration"]["minmax"]["launches"],
                     serve_dp_launches_per_forward=serve_dp["launches_per_forward"]["int8_gemm"])
        if (e["name"], e["path"]) in qat_trees:
            tree, kernel = qat_trees[(e["name"], e["path"])]
            e["qat_launches"] = qat["launches"][tree][kernel]
        if (e["name"], e["path"]) in swept:
            e["accuracy_sweep_launches"] = accuracy["sweep"][e["name"]]
        if (e["name"], e["path"]) in refined:
            e["accuracy_refined_launches"] = accuracy["refined"][e["name"]]
        if (e["name"], e["path"]) in (("int8_gemm", "resnet50"), ("residual_boundary", "resnet50")):
            e["s4_refined_launches"] = s4["resnet50_launches"][e["name"]]
        if (e["name"], e["path"]) in imagenet_paths:
            e["cli_imagenet_launches"] = {f"resnet50/{a}": c[e["name"]] for a, c in imagenet.items()
                                          if c[e["name"]]}
    print(f"kernels: int8_gemm exact (int32) and bit-equal (every store, the grouped-K and the "
          f"packed-B mode) on "
          f"its paths; fused_dynamic_gemm, residual_boundary and depthwise_conv bit-equal; no "
          "PyTorch call computes K1's fused store, its grouped-K mode, K2 or K3 alone (library: "
          "none; int32_library_ms is torch._int_mm against K1's int32 store; K4's library_ms is "
          "F.conv2d in f32 against its int32_ms; K4's ms are device time)")
    print(f"total {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
