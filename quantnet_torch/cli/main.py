"""The port's command line: import-torch / quantize / evaluate / bench / serve
(counterpart of the artifact stages of quantnet/cli/main.py).

    python -m quantnet_torch import-torch --ckpt model.pth
    python -m quantnet_torch quantize --scheme static --observer histogram
    python -m quantnet_torch evaluate --models fp32,static --per-class
    python -m quantnet_torch bench --batch-sizes 1,32,1024
    python -m quantnet_torch serve --scheme static --wire u8

Artifacts are the JAX package's format (quantnet_torch/train/checkpoint.py),
so either package reads what the other writes. Every stage runs on the card
(`--device cuda`, the default, which raises where there is none); `--device
cpu` runs the kernels' plain versions, for tests.

Not ported yet, and refused by name: `train`, `qat`, `report`, `scaling` and
`experiment`; the w4a8 scheme (ROADMAP Queue 1 item 1, with Queue 2 step 3's
batched int8 GEMM); the optimized scheme and --equalize, --adaround-steps,
--bias-correct, --int4-guard (Queue 1 item 4); QAT artifacts (Queue 1 item
5); ImageNet data (Queue 1 item 5); MobileNetV2 (Queue 1 item 3); serving
over several cards (--data-parallel) and bench's --s4-runtime (Queue 1 item
6).
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

SCHEMES = ("bf16", "dynamic", "static", "weight_only", "weight_only_int4")
RUNNABLE = ("fp32",) + SCHEMES
# Artifacts the JAX package writes that the port cannot run yet, with the
# ROADMAP item that brings each.
LATER = {
    "w4a8": "ROADMAP Queue 1 item 1 (W4A8, with Queue 2 step 3's batched int8 GEMM)",
    "optimized": "ROADMAP Queue 1 item 4 (the accuracy tools)",
    "qat": "ROADMAP Queue 1 item 5 (QAT)",
    "qat_int4": "ROADMAP Queue 1 item 5 (QAT)",
    "qat_w4a8": "ROADMAP Queue 1 item 5 (QAT)",
}
NOT_PORTED = (
    "Not ported yet: the w4a8 scheme (ROADMAP Queue 1 item 1); the optimized scheme and "
    "--equalize, --adaround-steps, --bias-correct, --int4-guard (Queue 1 item 4)."
)


def _torch_pad(meta) -> bool:
    """Imported torch weights need torch's symmetric stride-2 padding,
    recorded in the fp32 artifact's meta by import-torch."""
    return bool(meta and meta.get("torch_pad"))


def _apply_fn(name: str, conv1_scale: float = 1.0, torch_pad: bool = False):
    if name == "simple_convnet":
        from quantnet_torch.models import convnet

        return convnet.apply
    if name.startswith("resnet"):
        from quantnet_torch.models import resnet

        try:
            depth = int(name[len("resnet"):])
        except ValueError:
            raise SystemExit(f"unknown model {name!r}") from None
        if depth not in resnet.VARIANTS:
            raise SystemExit(f"unknown resnet depth {depth} (have {sorted(resnet.VARIANTS)})")
        kw = {}
        if conv1_scale != 1.0:
            kw["conv1_scale"] = conv1_scale
        if torch_pad:
            kw["torch_pad"] = True
        return functools.partial(resnet.apply, **kw) if kw else resnet.apply
    if name.startswith("mobilenetv2"):
        raise SystemExit("MobileNetV2 is not ported yet (ROADMAP Queue 1 item 3)")
    raise SystemExit(f"unknown model {name!r}")


def _load_data(args):
    from quantnet_torch.data import datasets

    if args.dataset == "cifar10":
        train, test = datasets.load_cifar10(
            args.data_dir, synthetic_train_size=args.synthetic_train_size,
            synthetic_test_size=args.synthetic_test_size,
        )
        return train, test, datasets.CIFAR10_CLASSES
    if args.dataset == "synthetic":
        train, test = datasets.make_synthetic(
            args.num_classes, args.image_size, args.synthetic_train_size, args.synthetic_test_size,
        )
        return train, test, None
    raise SystemExit(f"--dataset {args.dataset}: the ImageNet loader is not ported yet "
                     "(ROADMAP Queue 1 item 5)")


def _artifact_path(save_dir: str, name: str) -> str:
    return os.path.join(save_dir, name)


def _load_fp32(args):
    from quantnet_torch.train import checkpoint as ckpt

    path = _artifact_path(args.save_dir, "fp32")
    if not os.path.exists(path + ".json"):
        return None
    tree, meta = ckpt.load_artifact(path, device=args.device)
    return tree["params"], tree["state"], meta


def _calibration_batches(train, args):
    """The first --calibration-batches full batches, as the JAX package's
    islice over batches(..., drop_remainder=True) takes them, on the device."""
    import torch

    full = (x for x, y in train.batches(args.batch_size) if len(y) == args.batch_size)
    return [torch.from_numpy(x).to(args.device) for x in itertools.islice(full, args.calibration_batches)]


def _quantize(name, apply_fn, params, state, train, args):
    from quantnet_torch.quantize import bf16, dynamic, static, weight_only
    from quantnet_torch.quantize.fold import fold_model

    pc = not args.per_tensor
    if name == "bf16":
        return bf16.quantize(params, state)
    if name == "dynamic":
        return dynamic.quantize(params, state, per_channel=pc)
    if name == "weight_only":
        return weight_only.quantize(params, state, per_channel=pc)
    if name == "weight_only_int4":
        return weight_only.quantize(params, state, per_channel=pc, bits=4,
                                    group_size=args.int4_group_size or None)
    fparams, fstate = fold_model(params, state)
    act = static.calibrate(
        apply_fn, fparams, fstate, _calibration_batches(train, args),
        observer=args.observer, include_output_stats=args.pre_add_quant,
    )
    return static.bake(
        fparams, fstate, act, per_channel=pc,
        skip_first_layer=args.skip_first_layer, pre_add_quant=args.pre_add_quant,
    )


def cmd_quantize(args):
    from quantnet_torch.train import checkpoint as ckpt

    loaded = _load_fp32(args)
    if loaded is None:
        raise SystemExit(f"no fp32 artifact under {args.save_dir}; run import-torch first")
    params, state, meta = loaded
    train, _, _ = _load_data(args)
    apply_fn = _apply_fn(args.model, args.conv1_scale, _torch_pad(meta))
    for name in SCHEMES:
        if args.scheme not in ("all", name):
            continue
        qp, qs = _quantize(name, apply_fn, params, state, train, args)
        ckpt.save_artifact(
            _artifact_path(args.save_dir, name), {"params": qp, "state": qs},
            {"model": args.model, "scheme": name, "policy": None},
        )
        print(f"saved {name} artifact")


def _collect_models(args, requested=()):
    """{name: (apply_fn, params, state)} of the artifacts the port runs.
    Asking for one the port cannot run yet exits, naming the ROADMAP item;
    those on disk but not asked for are left out, and named on stderr."""
    from quantnet_torch.train import checkpoint as ckpt

    for name in requested:
        if name in LATER:
            raise SystemExit(f"the {name!r} artifact is not ported yet: {LATER[name]}")
    _, test, classes = _load_data(args)
    fp32 = _load_fp32(args)
    apply_fn = _apply_fn(args.model, args.conv1_scale, _torch_pad(fp32[2] if fp32 else None))
    models = {}
    for name in RUNNABLE:
        path = _artifact_path(args.save_dir, name)
        if os.path.exists(path + ".json"):
            tree, _ = ckpt.load_artifact(path, device=args.device)
            models[name] = (apply_fn, tree["params"], tree["state"])
    skipped = [n for n in LATER if os.path.exists(_artifact_path(args.save_dir, n) + ".json")]
    if skipped:
        print("left out, not ported yet: " + "; ".join(f"{n} ({LATER[n]})" for n in skipped),
              file=sys.stderr)
    return models, test, classes


def cmd_evaluate(args):
    from quantnet_torch.evaluation.evaluator import compare_models

    subset = [m for m in (args.models or "").split(",") if m]
    models, test, classes = _collect_models(args, subset)
    if not models:
        raise SystemExit("no artifacts to evaluate; run import-torch / quantize first")
    if subset:
        missing = [m for m in subset if m not in models]
        if missing:
            raise SystemExit(f"no artifacts for {missing}; have {sorted(models)}")
        models = {m: models[m] for m in subset}
    results = compare_models(models, test, batch_size=args.eval_batch_size,
                             class_names=classes, device=args.device)
    os.makedirs(args.results_dir, exist_ok=True)
    out_path = os.path.join(args.results_dir, "accuracy.json")
    to_write = results
    if subset and os.path.exists(out_path):
        # A subset merges into the table: the other rows stay.
        with open(out_path) as f:
            to_write = json.load(f)
        to_write.update(results)
    with open(out_path, "w") as f:
        json.dump(to_write, f, indent=2, default=str)
    for name, r in results.items():
        print(f"{name}: top1={r['top1']:.4f} top5={r['top5']:.4f} (n={r['n']})")
        if args.per_class and r.get("per_class"):
            ranked = sorted(r["per_class"].items(), key=lambda kv: -kv[1])
            for cls, acc in ranked[:20]:
                print(f"    {cls}: {acc:.4f}")
    return results


def cmd_bench(args):
    from quantnet_torch.bench.benchmark import InferenceBenchmark

    models, test, _ = _collect_models(args)
    if not models:
        raise SystemExit("no artifacts to bench; run import-torch / quantize first")
    h, _, c = test.image_shape
    bench = InferenceBenchmark(image_size=h, channels=c, warmup=args.warmup, iters=args.iters)
    batch_sizes = [int(b) for b in args.batch_sizes.split(",")]
    results = bench.compare_models(models, batch_sizes)
    os.makedirs(args.results_dir, exist_ok=True)
    with open(os.path.join(args.results_dir, "benchmark.json"), "w") as f:
        json.dump(results, f, indent=2)
    for name, r in results.items():
        for bs in batch_sizes:
            s = r[f"bs{bs}"]
            print(f"{name} bs={bs}: {s['mean_ms']:.3f}ms ({s['images_per_s']:.1f} img/s)")
    return results


def cmd_import_torch(args):
    """A reference PyTorch `.pth` -> the fp32 artifact."""
    from quantnet_torch.models.torch_import import import_checkpoint
    from quantnet_torch.train import checkpoint as ckpt

    _apply_fn(args.model)  # an unknown or unported model fails here
    params, state, best = import_checkpoint(args.ckpt, args.model, device=args.device)
    ckpt.save_artifact(
        _artifact_path(args.save_dir, "fp32"), {"params": params, "state": state},
        {"model": args.model, "best_accuracy": best, "imported_from": args.ckpt,
         # torch pads stride-2 convs symmetrically; the convnet's forward is
         # the same either way.
         "torch_pad": args.model.startswith(("resnet", "mobilenetv2"))},
    )
    msg = f"imported {args.ckpt} -> {args.save_dir}/fp32"
    if best is not None:
        msg += f" (best_accuracy {best:.4f})"
    print(msg)


def cmd_serve(args):
    """A load test of the continuous-batching engine over one artifact."""
    from quantnet_torch.serve import InferenceEngine

    requested = (args.scheme,) if args.scheme in LATER else ()
    models, test, _ = _collect_models(args, requested)
    if not models:
        raise SystemExit("no artifacts to serve; run import-torch / quantize first")
    if args.scheme is None:  # none named: static, else whatever is there
        name = "static" if "static" in models else sorted(models)[0]
    elif args.scheme in models:
        name = args.scheme
    else:
        raise SystemExit(f"no artifact for {args.scheme!r} in {args.save_dir}; have {sorted(models)}")
    apply_fn, params, state = models[name]
    shape = test.image_shape
    buckets = tuple(int(b) for b in args.buckets.split(","))
    rng = np.random.default_rng(args.seed)
    wire: Dict[str, object] = {}
    if args.wire == "u8":
        # Raw u8 payloads, normalized on the device with the data's statistics.
        c = shape[-1]
        mean = test.mean if test.mean is not None else np.zeros(c, np.float32)
        std = test.std if test.std is not None else np.ones(c, np.float32)
        wire = {"wire_dtype": "uint8", "normalize": (mean, std)}
        images = rng.integers(0, 256, size=(args.requests, *shape)).astype(np.uint8)
    else:
        images = rng.normal(size=(args.requests, *shape)).astype(np.float32)
    with InferenceEngine(apply_fn, params, state, image_shape=shape, buckets=buckets,
                         max_wait_ms=args.max_wait_ms, device=args.device, **wire) as eng:
        t0 = time.perf_counter()
        futs = [eng.submit(img) for img in images]
        for f in futs:
            f.result()
        dt = time.perf_counter() - t0
        stats, occ, lat = dict(eng.stats), eng.occupancy(), eng.latency_stats()
    print(
        f"served {args.requests} requests with '{name}' in {dt:.3f}s "
        f"({args.requests / dt:.1f} req/s), {int(stats['batches'])} batches, "
        f"occupancy {occ:.1%}, p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms"
    )
    return {"name": name, "seconds": dt, "stats": stats, "occupancy": occ, "latency": lat}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="quantnet_torch", description=__doc__.splitlines()[0],
                                epilog=NOT_PORTED)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default=None,
                        help="JSON file of {flag_dest: value} defaults (flags override it)")
        sp.add_argument("--model", default=None,
                        help="simple_convnet | resnet18/34/50/101/152 (default simple_convnet)")
        sp.add_argument("--dataset", default="cifar10", choices=["cifar10", "imagenet", "synthetic"],
                        help="imagenet is not ported yet (ROADMAP Queue 1 item 5)")
        sp.add_argument("--image-size", type=int, default=None, help="default 32")
        sp.add_argument("--num-classes", type=int, default=None, help="default 10")
        sp.add_argument("--conv1-scale", type=float, default=1.0,
                        help="resnet stem input scale (the reference's custom_scale)")
        sp.add_argument("--data-dir", default="./data")
        sp.add_argument("--save-dir", default="./saved_models")
        sp.add_argument("--results-dir", default="./results")
        sp.add_argument("--batch-size", type=int, default=128)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--synthetic-train-size", type=int, default=12800,
                        help="dataset size when no real data is on disk")
        sp.add_argument("--synthetic-test-size", type=int, default=2560)
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu (the "
                             "kernels' plain versions, for tests)")

    sp = sub.add_parser("import-torch", help="a reference .pth -> the fp32 artifact")
    common(sp)
    sp.add_argument("--ckpt", required=True,
                    help=".pth checkpoint (reference full-dict or raw state_dict)")
    sp.set_defaults(fn=cmd_import_torch)

    sp = sub.add_parser("quantize", help="the fp32 artifact -> one artifact per scheme",
                        epilog=NOT_PORTED)
    common(sp)
    sp.add_argument("--scheme", default="all", choices=["all", *SCHEMES])
    sp.add_argument("--observer", default="minmax",
                    choices=["minmax", "moving_average", "histogram", "mse"])
    sp.add_argument("--calibration-batches", type=int, default=16)
    sp.add_argument("--per-tensor", action="store_true",
                    help="per-tensor weight scales instead of per-channel")
    sp.add_argument("--int4-group-size", type=int, default=128,
                    help="weight_only_int4: rows of K that share a scale in dense layers "
                         "(0 = per-channel only)")
    sp.add_argument("--skip-first-layer", action="store_true",
                    help="static: keep the stem in fp32, handing int8 on")
    sp.add_argument("--pre-add-quant", action="store_true",
                    help="static: quantize residual operands before the add in downsample blocks")
    sp.set_defaults(fn=cmd_quantize)

    sp = sub.add_parser("evaluate", help="top-1 / top-5 / per-class of the artifacts")
    common(sp)
    sp.add_argument("--eval-batch-size", type=int, default=512)
    sp.add_argument("--models", default="",
                    help="comma-separated subset of artifacts (default: all the port runs); "
                         "a subset merges into an existing accuracy.json")
    sp.add_argument("--per-class", action="store_true",
                    help="print per-class accuracy (top 20, sorted desc)")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("bench", help="latency, throughput and size on the card")
    common(sp)
    sp.add_argument("--batch-sizes", default="1,32,1024")
    sp.add_argument("--warmup", type=int, default=10)
    sp.add_argument("--iters", type=int, default=100)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("serve", help="a load test of the continuous-batching engine")
    common(sp)
    sp.add_argument("--scheme", default=None,
                    help="artifact to serve; when none is named, static, else any available")
    sp.add_argument("--requests", type=int, default=256)
    sp.add_argument("--buckets", default="1,8,32,128")
    sp.add_argument("--max-wait-ms", type=float, default=2.0)
    sp.add_argument("--wire", default="f32", choices=["f32", "u8"],
                    help="u8: raw uint8 payloads normalized on the device")
    sp.set_defaults(fn=cmd_serve)
    return p


def _resolve_defaults(args):
    if args.model is None:
        args.model = "simple_convnet"
    if args.image_size is None:
        args.image_size = 32
    if args.num_classes is None:
        args.num_classes = 10


def main(argv: Optional[list] = None):
    from quantnet_torch.core.config import resolve_device

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    parser = build_parser()
    # --config file.json seeds defaults; explicit flags still win.
    if "--config" in argv:
        with open(argv[argv.index("--config") + 1]) as f:
            defaults = json.load(f)
        for sub_action in parser._subparsers._group_actions:
            for sp in sub_action.choices.values():
                known = {a.dest for a in sp._actions}
                sp.set_defaults(**{k: v for k, v in defaults.items() if k in known})
    args = parser.parse_args(argv)
    _resolve_defaults(args)
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    main()
