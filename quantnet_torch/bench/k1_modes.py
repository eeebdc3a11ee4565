#!/usr/bin/env python3
"""K1's packed-B and grouped-K launches, their int8-wide yardsticks, K2, and
K1's int8-wide launches at ResNet-50's GEMMs, timed as device time on one
card, for one checkout or for two in turns.

    python quantnet_torch/bench/k1_modes.py                  # this checkout
    python quantnet_torch/bench/k1_modes.py --ab PARENT_ROOT # PARENT, this, this, PARENT

Each checkout runs in a process of its own, which imports `quantnet_torch`
from that checkout's root and builds its kernels there (build/ under it).
A case's time is device_ms: 20 launches captured in one CUDA graph and the
graph replayed 5 times between CUDA events, so the host's cost of a call is
left out. With --ab the two checkouts run PARENT, this, this, PARENT on the
same card, and each case's figure is the mean of a checkout's two runs.

The cases, on random operands from a seed, each with the epilogue its path
gives it:
- the W4A8 convnet's convs under the s4 runtime (packed B, the int8 store
  with zero point, bias and relu) at bs1024 and at a bs1 forward's own
  shapes (M = H x W of one image), and the same launch on the widened
  weight;
- the grouped-K mode (g128) at the W4A8 dense layers: the convnet's fc1
  (int8 store, relu) and fc2 (f32 store) at bs1024 and bs1, ResNet-50's fc
  at bs128, MobileNetV2's fc at bs256; fc1 at g32, g64 and g256; each with
  an int8-wide and a packed B;
- K2 (fused_dynamic_gemm) at the convnet's fc1 and fc2 at bs1024 and bs32;
- K1's int8-wide launches at ResNet-50's bs128 GEMMs with the int8 store;
- the host's cost of one K1 call (the "host us" cases, in ms like the rest:
  wall time of back-to-back calls that the card runs faster than the host
  issues them).

Prints one line per case and, last, one JSON object with every figure
(also written to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED = 0
# (name, rows of one image, K, N) of the W4A8 convnet's convs (im2col).
CONVS = [("conv2", 1024, 576, 64), ("conv3", 256, 576, 128), ("conv4", 256, 1152, 128),
         ("conv5", 64, 1152, 256), ("conv6", 64, 2304, 256)]
# (name, M, K, N, group, store) of the grouped-K launches.
GROUPED = [("fc1", 1024, 4096, 512, 128, "int8"), ("fc2", 1024, 512, 10, 128, "f32"),
           ("fc1", 1, 4096, 512, 128, "int8"), ("fc2", 1, 512, 10, 128, "f32"),
           ("resnet50_fc", 128, 2048, 1000, 128, "f32"), ("mobilenetv2_fc", 256, 1280, 1000, 128, "f32")] + [
    ("fc1", m, 4096, 512, g, "int8") for g in (32, 64, 256) for m in (1024, 1)]
# (name, M, K, N) of K2's launches: the dynamic convnet's fc1 and fc2.
K2 = [("fc1", m, 4096, 512) for m in (1024, 32)] + [("fc2", m, 512, 10) for m in (1024, 32)]


def device_ms(torch, fn, launches: int = 20, replays: int = 5) -> float:
    """Device ms per call: `launches` calls in one CUDA graph, replayed."""
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


def resnet50_gemms(batch: int = 128, image: int = 224):
    """ResNet-50's int8 GEMMs (M, K, N) at (batch, image): the 52 convs
    through im2col and the fc, distinct shapes."""
    shapes, h, cin = set(), -(-image // 2), 64
    h = (h + 2 - 3) // 2 + 1
    for si, (blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            ho, cout = -(-h // stride), width * 4
            shapes |= {(batch * h * h, cin, width), (batch * ho * ho, 9 * width, width),
                       (batch * ho * ho, width, cout)}
            if bi == 0:
                shapes.add((batch * ho * ho, cin, cout))
            h, cin = ho, cout
    shapes.add((batch, cin, 1000))
    return sorted(shapes)


def run_tree(tree: Path) -> dict:
    """Times every case with the quantnet_torch of `tree`; returns {case:
    {"ms": .., "plan": ..}}."""
    sys.path.insert(0, str(tree))
    import torch

    from quantnet_torch.core.types import ActQuant, pack_nibbles
    from quantnet_torch.ops import int8_matmul as k1
    from quantnet_torch.ops.fused_dynamic_matmul import fused_dynamic_gemm

    if not torch.cuda.is_available():
        raise SystemExit("k1_modes: no CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    plan_of = getattr(k1, "launch_plan", None)
    out = {}

    def case(name, fn, a=None, b=None, epi=None):
        ms = device_ms(torch, fn)
        plan = str(plan_of(a, b, epi)) if plan_of is not None and a is not None else None
        out[name] = {"ms": ms, "plan": plan}
        print(f"  {name}: {ms:.4f} ms" + (f" ({plan})" if plan else ""), flush=True)

    def host(name, fn, iters=500):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out[name] = {"ms": (time.perf_counter() - t0) / iters * 1e3, "plan": None}
        print(f"  {name}: {out[name]['ms'] * 1e3:.2f} us a call", flush=True)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int8)

    def conv_epi(n):
        return k1.Epilogue(cs=torch.rand((n,), generator=g, device=dev) * 1e-3,
                           bias=torch.randn((n,), generator=g, device=dev),
                           zpw=torch.randint(-9000, 9000, (n,), generator=g, device=dev, dtype=torch.int32),
                           act="relu", out=torch.int8,
                           out_quant=ActQuant(torch.tensor(0.05, device=dev),
                                              torch.tensor(-128, dtype=torch.int32, device=dev)))

    def grouped_epi(k, n, group, store):
        gs = torch.rand((k // group, n), generator=g, device=dev) * 1e-2 + 1e-4
        gzpw = torch.randint(-30000, 30000, (k // group, n), generator=g, device=dev, dtype=torch.int32)
        cs = torch.full((n,), 0.0371, device=dev)
        bias = torch.randn((n,), generator=g, device=dev)
        if store == "int8":
            oq = ActQuant(torch.tensor(0.0613, device=dev), torch.tensor(-11, dtype=torch.int32, device=dev))
            return k1.Epilogue(cs=cs, bias=bias, act="relu", out=torch.int8, out_quant=oq, group=group,
                               gs=gs, gzpw=gzpw)
        return k1.Epilogue(cs=cs, bias=bias, group=group, gs=gs, gzpw=gzpw)

    def variants(m, k, n, store, group=None, packed=True):
        """Other plans of a packed or grouped launch than the default, where
        the checkout has them (k1_plan's slots and split): {label: plan}."""
        if not hasattr(k1, "k1_plan"):
            return {}
        out, default = {}, k1.k1_plan(m, n, k, store, group, packed)
        for label, kw in (("2 slots", {"slots": 2}), ("3 slots", {"slots": 3}), ("no split", {"split": 1}),
                          ("split 2", {"split": 2}), ("split 4", {"split": 4}), ("split 8", {"split": 8})):
            if (group is not None and "slots" in kw) or ("split" in kw and m > 4096) or (
                    "slots" in kw and m <= 4096):
                continue
            try:
                plan = k1.k1_plan(m, n, k, store, group, packed, **kw)
            except ValueError:
                continue
            if plan != default:
                out[label] = plan
        return out

    for name, rows, k, n in CONVS:
        w = ints((n, k), -8, 8)
        packed, epi = pack_nibbles(w), conv_epi(n)
        for bs in (1024, 1):
            a = ints((rows * bs, k), -128, 128)
            case(f"packed {name} {rows * bs}x{k}x{n}", lambda: k1.int8_gemm_epilogue(a, packed, epi),
                 a, packed, epi)
            for label, plan in variants(rows * bs, k, n, 3).items():
                case(f"packed {name} {rows * bs}x{k}x{n} {label}",
                     lambda: k1.int8_gemm_epilogue(a, packed, epi, plan=plan))
            case(f"int8-wide {name} {rows * bs}x{k}x{n}", lambda: k1.int8_gemm_epilogue(a, w, epi), a, w, epi)
            del a
    for name, m, k, n, group, store in GROUPED:
        a, w = ints((m, k), -128, 128), ints((n, k), -8, 8)
        epi, packed = grouped_epi(k, n, group, store), pack_nibbles(w)
        case(f"grouped {name} {m}x{k}x{n} g{group} {store}", lambda: k1.int8_gemm_epilogue(a, w, epi),
             a, w, epi)
        case(f"grouped packed {name} {m}x{k}x{n} g{group} {store}",
             lambda: k1.int8_gemm_epilogue(a, packed, epi), a, packed, epi)
        code = 3 if store == "int8" else 1
        for label, plan in variants(m, k, n, code, group, False).items():
            case(f"grouped {name} {m}x{k}x{n} g{group} {store} {label}",
                 lambda: k1.int8_gemm_epilogue(a, w, epi, plan=plan))
    for name, m, k, n in K2:
        # fc1 takes conv6's bf16 handoff, fc2 fc1's f32 output.
        x = (torch.randn((m, k), generator=g, device=dev) * 2.0).to(
            torch.bfloat16 if name == "fc1" else torch.float32)
        w = ints((n, k), -127, 128)
        scale = torch.rand((n,), generator=g, device=dev) * 1e-2
        bias = torch.randn((n,), generator=g, device=dev)
        relu = name == "fc1"
        case(f"K2 {name} {m}x{k}x{n}", lambda: fused_dynamic_gemm(x, w, scale, bias, relu))
    # The host's cost of one call where the card runs it faster than the
    # host issues it (wall time of back-to-back calls): K1's int32 store,
    # a grouped and a packed launch at bs1.
    a, w = ints((128, 64), -127, 128), ints((64, 64), -127, 128)
    host("host us int8_gemm int32 128x64x64", lambda: k1.int8_gemm(a, w))
    a, w = ints((1, 4096), -128, 128), ints((512, 4096), -8, 8)
    epi = grouped_epi(4096, 512, 128, "int8")
    host("host us grouped fc1 1x4096x512 g128 int8", lambda: k1.int8_gemm_epilogue(a, w, epi))
    if hasattr(k1, "k1_plan"):  # the same launch without its cluster split
        one = k1.k1_plan(1, 512, 4096, 3, 128, split=1)
        host("host us grouped fc1 1x4096x512 g128 int8 no split",
             lambda: k1.int8_gemm_epilogue(a, w, epi, plan=one))
    w, epi = pack_nibbles(ints((256, 2304), -8, 8)), conv_epi(256)
    a = ints((64, 2304), -128, 128)
    host("host us packed conv6 64x2304x256", lambda: k1.int8_gemm_epilogue(a, w, epi))
    for m, k, n in resnet50_gemms():
        kp = -(-k // 16) * 16
        a, w, epi = ints((m, kp), -128, 128), ints((n, kp), -127, 128), conv_epi(n)
        case(f"int8-wide resnet50 {m}x{kp}x{n}", lambda: k1.int8_gemm_epilogue(a, w, epi), a, w, epi)
        del a
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="the checkout whose quantnet_torch to time")
    ap.add_argument("--ab", type=Path, help="a second checkout, run before and after this one")
    ap.add_argument("--out", type=Path, help="write the JSON object here too")
    args = ap.parse_args()
    if args.ab is None:
        t0 = time.perf_counter()
        res = run_tree(args.tree.resolve())
        print(f"k1_modes {args.tree}: {len(res)} cases in {time.perf_counter() - t0:.1f} s", flush=True)
        text = json.dumps({"tree": str(args.tree), "cases": res})
    else:
        runs = []
        for tree in (args.ab, args.tree, args.tree, args.ab):
            proc = subprocess.run([sys.executable, __file__, "--tree", str(tree.resolve())],
                                  capture_output=True, text=True, env=dict(os.environ))
            sys.stdout.write(proc.stdout)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr)
                return proc.returncode
            runs.append((tree, json.loads(proc.stdout.strip().splitlines()[-1])["cases"]))
        parent, this = [runs[0][1], runs[3][1]], [runs[1][1], runs[2][1]]
        rows = {}
        for name in this[0]:
            p = [r[name]["ms"] for r in parent if name in r]
            t = [r[name]["ms"] for r in this]
            rows[name] = {"parent_ms": sum(p) / len(p) if p else None, "ms": sum(t) / len(t),
                          "parent_runs": p, "runs": t, "plan": this[0][name]["plan"],
                          "parent_plan": parent[0].get(name, {}).get("plan")}
            ratio = f"{rows[name]['ms'] / rows[name]['parent_ms']:.3f}x" if p else "new"
            print(f"{name}: parent {p} -> {t} ms ({ratio})")
        text = json.dumps({"parent": str(args.ab), "tree": str(args.tree), "cases": rows})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
