"""The port's command line: train / import-torch / quantize / qat / evaluate /
bench / report / scaling / serve / experiment (counterpart of
quantnet/cli/main.py).

    python -m quantnet_torch train --epochs 20 --batch-size 128
    python -m quantnet_torch import-torch --ckpt model.pth
    python -m quantnet_torch quantize --scheme static --observer histogram
    python -m quantnet_torch quantize --scheme w4a8 --int4-group-size 128
    python -m quantnet_torch quantize --equalize --int4-guard 50 --adaround-steps 400 \
        --bias-correct
    python -m quantnet_torch qat --epochs 2 --weight-bits 4 --init-from w4a8
    python -m quantnet_torch evaluate --models fp32,static --per-class
    python -m quantnet_torch bench --batch-sizes 1,32,1024
    python -m quantnet_torch serve --scheme static --wire u8 --data-parallel -1
    python -m quantnet_torch report
    python -m quantnet_torch scaling --per-device-batch 256
    python -m quantnet_torch experiment --epochs 20 --qat-epochs 2

Artifacts are the JAX package's format (quantnet_torch/train/checkpoint.py),
so either package reads what the other writes. Every stage runs on the card
(`--device cuda`, the default, which raises where there is none); `--device
cpu` runs the kernels' plain versions, for tests.

Models: simple_convnet, resnet18/34/50/101/152 and mobilenetv2 (with a width
suffix, mobilenetv2_0.5). `quantize` writes the seven schemes of the JAX
CLI, `optimized` (the measured mixed-precision policy, written into the
artifact's meta) among them, with its accuracy tools in the JAX CLI's order
and scope (quantnet/cli/main.py:135-246, 310-318): --equalize before every
scheme; --int4-guard measured on the first two calibration batches and
applied to weight_only_int4 and w4a8; --adaround-steps and then
--bias-correct on the requested sub-byte tiers; the optimized sweep on the
first quarter of the calibration batches. `train` writes the fp32
artifact (and `history.jsonl`, and a resumable `best.pt` checkpoint);
`qat` finetunes the fp32 artifact, or with --init-from a quantized one,
through fake quantization and writes `qat`, `qat_w4a8` (--weight-bits 4) or
`qat_int4` (--weight-bits 4 --weight-only) (quantnet/cli/main.py:250-285,
333-447). `evaluate`, `bench` and `serve` load every artifact on disk, as
the JAX CLI does; `serve --data-parallel N` splits each batch over N local
devices (-1: every card). `report` writes the comparison table and the
markdown report from accuracy.json and benchmark.json; `scaling` the
weak-scaling sweep over the local cards (results/scaling.json);
`experiment` runs train -> quantize all -> qat -> evaluate -> bench ->
report (quantnet/cli/main.py:685-704). `bench --s4-runtime` benches the
sub-byte tiers with their 4-bit weights nibble-packed in device memory
(quantize/common.py::s4_runtime_tree; the same logits, half the weight
bytes). Not ported yet, and refused by name: ImageNet data (ROADMAP Queue 1
item 4).
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

SCHEMES = ("bf16", "dynamic", "static", "weight_only", "weight_only_int4", "w4a8", "optimized")
SUB_BYTE = ("weight_only_int4", "w4a8")
# Every artifact evaluate, bench and serve load, in the JAX CLI's order
# (quantnet/cli/main.py:466-468).
RUNNABLE = ("fp32",) + SCHEMES + ("qat", "qat_int4", "qat_w4a8")
NOT_PORTED = "Not ported yet (ROADMAP): --dataset imagenet (Queue 1 item 4)."


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
        from quantnet_torch.models import mobilenet

        # An optional width suffix, mobilenetv2_0.5: the width is read off the
        # weights' shapes, so it only has to parse.
        if name != "mobilenetv2":
            try:
                float(name.split("_", 1)[1])
            except (IndexError, ValueError):
                raise SystemExit(f"unknown model {name!r}") from None
        return functools.partial(mobilenet.apply, torch_pad=True) if torch_pad else mobilenet.apply
    raise SystemExit(f"unknown model {name!r}")


def _build_model(args, num_classes: int, image_size: int):
    """(apply_fn, params, state) of a fresh model, its weights drawn from a
    CPU generator seeded --seed (the same weights on any device)."""
    import torch

    apply_fn = _apply_fn(args.model, args.conv1_scale)
    gen = torch.Generator().manual_seed(args.seed)
    name = args.model
    if name == "simple_convnet":
        from quantnet_torch.models import convnet

        params, state = convnet.init(gen, num_classes=num_classes, image_size=image_size,
                                     device=args.device)
    elif name.startswith("resnet"):
        from quantnet_torch.models import resnet

        params, state = resnet.init(gen, num_classes=num_classes, depth=int(name[len("resnet"):]),
                                    zero_init_residual=args.zero_init_residual, device=args.device)
    else:
        from quantnet_torch.models import mobilenet

        width = float(name.split("_", 1)[1]) if "_" in name else 1.0
        params, state = mobilenet.init(gen, num_classes=num_classes, width_mult=width,
                                       device=args.device)
    return apply_fn, params, state


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
                     "(ROADMAP Queue 1 item 4)")


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


class _Inputs:
    """What the schemes share, each made once, when a scheme first needs it:
    the calibration batches, the static calibration (folded params, state,
    activation qparams) and the int4 guard."""

    def __init__(self, params, state, apply_fn, train, args):
        self.params, self.state, self.apply_fn = params, state, apply_fn
        self.train, self.args = train, args

    @functools.cached_property
    def calib(self) -> list:
        return _calibration_batches(self.train, self.args)

    @functools.cached_property
    def calibrated(self):
        from quantnet_torch.quantize import static
        from quantnet_torch.quantize.fold import fold_model

        fparams, fstate = fold_model(self.params, self.state)
        act = static.calibrate(self.apply_fn, fparams, fstate, self.calib,
                               observer=self.args.observer,
                               include_output_stats=self.args.pre_add_quant)
        return fparams, fstate, act

    @functools.cached_property
    def guard(self) -> dict:
        """The measured int4 guard (--int4-guard > 0): layers whose 4-bit
        damage on the first two calibration batches is an outlier keep 8-bit
        weights in the sub-byte tiers (quantnet/cli/main.py:170-187)."""
        if not self.args.int4_guard > 0:
            return {}
        from quantnet_torch.quantize.policy import int4_guard

        guard = int4_guard(self.apply_fn, self.params, self.state, self.calib[:2],
                           group_size=self.args.int4_group_size or None,
                           rel_threshold=self.args.int4_guard)
        if guard:
            print(f"int4 guard: 8-bit weights kept at {sorted(guard)}")
        return guard


def _quantize(name, inputs: _Inputs, args):
    """One scheme's (params, state, policy): the JAX CLI's bake of it
    (quantnet/cli/main.py:135-246), then AdaRound and bias correction on a
    sub-byte tier where asked. `policy` is the optimized scheme's table,
    else None."""
    from quantnet_torch.quantize import bf16, dynamic, static, weight_only
    from quantnet_torch.quantize.common import first_layer_path
    from quantnet_torch.quantize.policy import quantize_optimized

    params, state, apply_fn = inputs.params, inputs.state, inputs.apply_fn
    pc = not args.per_tensor
    int4_gs = args.int4_group_size or None
    if name == "optimized":
        # The sweep on the first quarter of the calibration batches.
        return quantize_optimized(
            params, state, apply_fn, inputs.calib[: max(args.calibration_batches // 4, 1)],
            importance=args.importance or "sensitivity",
            low_precision_scheme=args.optimized_low_tier, int4_group_size=int4_gs,
        )
    if name == "bf16":
        qp, qs = bf16.quantize(params, state)
    elif name == "dynamic":
        qp, qs = dynamic.quantize(params, state, per_channel=pc)
    elif name == "weight_only":
        qp, qs = weight_only.quantize(params, state, per_channel=pc)
    elif name == "weight_only_int4":
        # Per channel whatever --per-tensor says, as the JAX CLI bakes it.
        qp, qs = weight_only.quantize(params, state, bits=4, group_size=int4_gs,
                                      layer_policy=inputs.guard or None)
    elif name == "w4a8":
        # 4-bit weights in the static int8-activation path, group-wise along
        # K in dense layers (quantnet/cli/main.py:196-204). Under
        # --skip-first-layer the stem is fp32 already: a guard entry for it
        # would quantize it instead.
        fparams, fstate, act = inputs.calibrated
        guard = dict(inputs.guard)
        if args.skip_first_layer:
            guard.pop(first_layer_path(fparams), None)
        qp, qs = static.bake(fparams, fstate, act, skip_first_layer=args.skip_first_layer,
                             weight_bits=4, weight_group_size=int4_gs, layer_policy=guard or None)
    else:
        fparams, fstate, act = inputs.calibrated
        qp, qs = static.bake(fparams, fstate, act, per_channel=pc,
                             skip_first_layer=args.skip_first_layer,
                             pre_add_quant=args.pre_add_quant)
    if name in SUB_BYTE and args.adaround_steps:
        from quantnet_torch.quantize import adaround

        qp, qs = adaround.refine(qp, qs, params, state, apply_fn, inputs.calib,
                                 steps=args.adaround_steps)
    if name in SUB_BYTE and args.bias_correct:
        from quantnet_torch.quantize.bias_correct import bias_correct

        qp, qs = bias_correct(qp, qs, params, state, apply_fn, inputs.calib)
    return qp, qs, None


def cmd_train(args):
    """Train a fresh model; write the fp32 artifact, history.jsonl and the
    best epoch's checkpoint (best.pt, which --resume reads)."""
    from quantnet_torch.core.config import TrainConfig
    from quantnet_torch.train import checkpoint as ckpt
    from quantnet_torch.train.trainer import Trainer

    train, test, _ = _load_data(args)
    apply_fn, params, state = _build_model(args, train.num_classes, train.image_shape[0])
    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr, optimizer=args.optimizer,
        seed=args.seed, save_dir=args.save_dir, aug_rotation_deg=args.aug_rotation,
        aug_color_jitter=args.aug_color_jitter, warmup_epochs=args.warmup_epochs,
    )
    trainer = Trainer(apply_fn, params, state, cfg, train, test, device=args.device)
    params, state = trainer.train(
        save_path=os.path.join(args.save_dir, "best") if args.save_dir else None, resume=args.resume,
    )
    ckpt.save_artifact(_artifact_path(args.save_dir, "fp32"), {"params": params, "state": state},
                       {"model": args.model, "best_accuracy": trainer.best_accuracy})
    trainer.save_history(os.path.join(args.save_dir, "history.jsonl"))
    print(f"best accuracy: {trainer.best_accuracy:.4f}")
    return {"best_accuracy": trainer.best_accuracy, "history": trainer.history}


def cmd_qat(args):
    """Finetune the fp32 artifact through fake quantization (quantize/qat.py),
    bake it and save it: 'qat' (8-bit weights, static INT8), 'qat_w4a8'
    (--weight-bits 4) or 'qat_int4' (--weight-bits 4 --weight-only, the
    classifier f32). --init-from starts from a quantized artifact's weights
    (an AdaRound-refined w4a8, say) instead of the fp32 tree."""
    from quantnet_torch.core.config import TrainConfig
    from quantnet_torch.quantize import qat
    from quantnet_torch.train import checkpoint as ckpt
    from quantnet_torch.train.trainer import Trainer

    loaded = _load_fp32(args)
    if loaded is None:
        raise SystemExit(f"no fp32 artifact under {args.save_dir}; run train first")
    params, state, meta = loaded
    train, test, _ = _load_data(args)
    apply_fn = _apply_fn(args.model, args.conv1_scale, _torch_pad(meta))
    calib = _calibration_batches(train, args)
    if args.weight_only and args.weight_bits == 8 and not args.artifact_name:
        # It would take the 'qat' name and pass for the static INT8 QAT row.
        raise SystemExit("--weight-only targets the sub-byte tier; pass --weight-bits 4 "
                         "(or an explicit --artifact-name for a weight-only int8 QAT)")
    group_size = (args.weight_group_size or None) if args.weight_bits == 4 else None
    guard = {}
    if args.weight_bits == 4 and args.int4_guard > 0:
        # Outlier layers train and bake with 8-bit weights, as in quantize.
        from quantnet_torch.quantize.common import first_layer_path
        from quantnet_torch.quantize.policy import int4_guard

        guard = int4_guard(apply_fn, params, state, calib[:2], group_size=group_size,
                           rel_threshold=args.int4_guard)
        if guard and args.skip_first_layer:
            guard.pop(first_layer_path(params), None)
        if guard:
            print(f"int4 guard: 8-bit weight islands at {sorted(guard)}")
    fold = True
    if args.init_from:
        src = _artifact_path(args.save_dir, args.init_from)
        if not os.path.exists(src + ".json"):
            raise SystemExit(f"--init-from artifact {src!r} not found; run quantize first")
        tree, _ = ckpt.load_artifact(src, device=args.device)
        # Quantized artifacts are BN-folded: f32 weights on their grid, no re-fold.
        params, state, fold = qat.dequantize_tree(tree["params"]), tree["state"], False
    qp, qs = qat.prepare(
        params, state, apply_fn, calib, observer=args.observer, per_channel=not args.per_tensor,
        skip_first_layer=args.skip_first_layer,
        # The weight-only tier keeps the classifier f32, as weight_only.quantize does.
        skip_last_layer=args.weight_only, layer_policy=guard or None,
        weight_bits=args.weight_bits, weight_group_size=group_size,
        act_quant=not args.weight_only, fold=fold,
    )
    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr, optimizer=args.optimizer,
        seed=args.seed, save_dir=args.save_dir,
        # The BN-folded STE graph has no normalization left to damp a bad step.
        grad_clip_norm=args.grad_clip_norm,
    )
    trainer = Trainer(apply_fn, qp, qs, cfg, train, test, device=args.device)
    qp, qs = trainer.train()  # the best epoch's tree
    name = args.artifact_name or (
        "qat" if args.weight_bits == 8 else ("qat_int4" if args.weight_only else "qat_w4a8"))
    ckpt.save_artifact(
        _artifact_path(args.save_dir, name), {"params": qat.bake(qp), "state": qs},
        {"model": args.model, "scheme": name, "weight_bits": args.weight_bits,
         "init_from": args.init_from or None, "qat_best_accuracy": trainer.best_accuracy},
    )
    print(f"qat finetune best accuracy (fake-quant graph): {trainer.best_accuracy:.4f}; "
          f"saved {name} artifact")
    return {"name": name, "best_accuracy": trainer.best_accuracy, "history": trainer.history}


def cmd_quantize(args):
    from quantnet_torch.train import checkpoint as ckpt

    loaded = _load_fp32(args)
    if loaded is None:
        raise SystemExit(f"no fp32 artifact under {args.save_dir}; run import-torch first")
    params, state, meta = loaded
    train, _, _ = _load_data(args)
    apply_fn = _apply_fn(args.model, args.conv1_scale, _torch_pad(meta))
    if args.equalize:
        # Data-free range equalization before every scheme.
        from quantnet_torch.quantize.equalize import cross_layer_equalize

        params, state = cross_layer_equalize(params, state)
        print("applied cross-layer equalization")
    inputs = _Inputs(params, state, apply_fn, train, args)
    for name in SCHEMES:
        if args.scheme not in ("all", name):
            continue
        qp, qs, policy = _quantize(name, inputs, args)
        ckpt.save_artifact(
            _artifact_path(args.save_dir, name), {"params": qp, "state": qs},
            {"model": args.model, "scheme": name, "policy": policy},
        )
        print(f"saved {name} artifact")


def _collect_models(args):
    """{name: (apply_fn, params, state)} of every artifact on disk, in the
    JAX CLI's order."""
    from quantnet_torch.train import checkpoint as ckpt

    _, test, classes = _load_data(args)
    fp32 = _load_fp32(args)
    apply_fn = _apply_fn(args.model, args.conv1_scale, _torch_pad(fp32[2] if fp32 else None))
    models = {}
    for name in RUNNABLE:
        path = _artifact_path(args.save_dir, name)
        if os.path.exists(path + ".json"):
            tree, _ = ckpt.load_artifact(path, device=args.device)
            models[name] = (apply_fn, tree["params"], tree["state"])
    return models, test, classes


def cmd_evaluate(args):
    from quantnet_torch.evaluation.evaluator import compare_models

    subset = [m for m in (args.models or "").split(",") if m]
    models, test, classes = _collect_models(args)
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
    if args.s4_runtime:
        # The sub-byte tiers' weights nibble-packed in device memory
        # (quantnet/cli/main.py:521-540): the same logits, half the weight bytes.
        from quantnet_torch.quantize.common import s4_runtime_tree

        models = {name: (fn, s4_runtime_tree(p), s) for name, (fn, p, s) in models.items()}
    h, _, c = test.image_shape
    bench = InferenceBenchmark(image_size=h, channels=c, warmup=args.warmup, iters=args.iters,
                               device=args.device)
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

    models, test, _ = _collect_models(args)
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
    mesh = None
    if args.data_parallel != 1:
        from quantnet_torch.parallel.mesh import local_devices, make_mesh

        mesh = make_mesh(args.data_parallel, devices=local_devices(args.device))
    with InferenceEngine(apply_fn, params, state, image_shape=shape, buckets=buckets,
                         max_wait_ms=args.max_wait_ms, device=args.device, mesh=mesh, **wire) as eng:
        t0 = time.perf_counter()
        futs = [eng.submit(img) for img in images]
        for f in futs:
            f.result()
        dt = time.perf_counter() - t0
        stats, occ, lat = dict(eng.stats), eng.occupancy(), eng.latency_stats()
    shards = f" over {mesh.size} shards" if mesh is not None else ""
    print(
        f"served {args.requests} requests with '{name}'{shards} in {dt:.3f}s "
        f"({args.requests / dt:.1f} req/s), {int(stats['batches'])} batches, "
        f"occupancy {occ:.1%}, p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms"
    )
    return {"name": name, "seconds": dt, "stats": stats, "occupancy": occ, "latency": lat,
            "shards": mesh.size if mesh is not None else 1}


def cmd_scaling(args):
    """The weak-scaling sweep over the local devices, on the static artifact
    (else any, else a fresh fp32 model) -> results/scaling.json."""
    from quantnet_torch.bench.scaling import measure_scaling
    from quantnet_torch.parallel.mesh import local_devices

    models, _, _ = _collect_models(args)
    if models:
        name = "static" if "static" in models else sorted(models)[0]
        apply_fn, params, state = models[name]
    else:
        name = "fp32-init"
        apply_fn, params, state = _build_model(args, args.num_classes, args.image_size)
    res = measure_scaling(apply_fn, params, state, image_size=args.image_size,
                          per_device_batch=args.per_device_batch, iters=args.iters,
                          devices=local_devices(args.device))
    os.makedirs(args.results_dir, exist_ok=True)
    with open(os.path.join(args.results_dir, "scaling.json"), "w") as f:
        json.dump({"model": name, **{k: {str(n): v for n, v in res[k].items()}
                                     for k in ("throughput", "efficiency")}}, f, indent=2)
    for n, tp in sorted(res["throughput"].items()):
        eff = res["efficiency"].get(n, 1.0)
        print(f"{name} x{n} devices ({res['device']}): {tp:.1f} img/s (efficiency {eff:.1%})")
    return res


def cmd_report(args):
    """The comparison table (CSV, JSON, plot) and the markdown report from
    accuracy.json and benchmark.json."""
    from quantnet_torch.report.analyzer import ResultAnalyzer, create_detailed_report

    acc_path = os.path.join(args.results_dir, "accuracy.json")
    bench_path = os.path.join(args.results_dir, "benchmark.json")
    if not (os.path.exists(acc_path) and os.path.exists(bench_path)):
        raise SystemExit("need accuracy.json and benchmark.json; run evaluate + bench")
    with open(acc_path) as f:
        accuracy = json.load(f)
    with open(bench_path) as f:
        benchmark = json.load(f)
    table = ResultAnalyzer(args.results_dir).compare_quantization_methods(
        accuracy, benchmark, batch_size=args.report_batch_size)
    report = create_detailed_report(table, args.results_dir)
    print(report)
    return report


def _stage_args(args, cmd: str, **overrides) -> argparse.Namespace:
    """The namespace `cmd` gets from the experiment's flags: the stage's own
    defaults, under every flag the experiment shares with it."""
    stage = build_parser().parse_args([cmd])
    shared = {k: v for k, v in vars(args).items() if k in vars(stage) and k not in ("cmd", "fn")}
    vars(stage).update(shared, **overrides)
    return stage


def cmd_experiment(args):
    """The whole pipeline: train (unless --skip-training finds the fp32
    artifact) -> quantize every scheme -> the QAT finetune (--qat-epochs, at
    a tenth of --lr) -> evaluate -> bench -> report, so the report covers
    the PTQ tiers and QAT in one run."""
    if not (args.skip_training and _load_fp32(args) is not None):
        cmd_train(_stage_args(args, "train"))
    cmd_quantize(_stage_args(args, "quantize", scheme="all"))
    if args.qat_epochs > 0:
        cmd_qat(_stage_args(args, "qat", epochs=args.qat_epochs, lr=args.lr * 0.1))
    accuracy = cmd_evaluate(_stage_args(args, "evaluate"))
    benchmark = cmd_bench(_stage_args(args, "bench"))
    report = cmd_report(_stage_args(args, "report"))
    return {"accuracy": accuracy, "benchmark": benchmark, "report": report}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="quantnet_torch", description=__doc__.splitlines()[0],
                                epilog=NOT_PORTED)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default=None,
                        help="JSON file of {flag_dest: value} defaults (flags override it)")
        sp.add_argument("--model", default=None,
                        help="simple_convnet | resnet18/34/50/101/152 | mobilenetv2[_<width>] "
                             "(default simple_convnet)")
        sp.add_argument("--dataset", default="cifar10", choices=["cifar10", "imagenet", "synthetic"],
                        help="imagenet is not ported yet (ROADMAP Queue 1 item 4)")
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

    def train_recipe(sp):
        sp.add_argument("--optimizer", default="sgd_cosine", choices=["sgd_cosine", "adam_plateau"])

    sp = sub.add_parser("train", help="train a fresh model -> the fp32 artifact")
    common(sp)
    sp.add_argument("--epochs", type=int, default=20)
    sp.add_argument("--lr", type=float, default=0.1)
    train_recipe(sp)
    sp.add_argument("--resume", action="store_true",
                    help="continue from the best checkpoint in --save-dir (best.pt)")
    sp.add_argument("--aug-rotation", type=float, default=0.0,
                    help="random rotation range in degrees (the reference's RandomRotation(15)); "
                         "0 disables")
    sp.add_argument("--aug-color-jitter", type=float, default=0.0,
                    help="brightness / saturation / contrast jitter strength (the reference's "
                         "ColorJitter(.2, .2, .2)); 0 disables")
    sp.add_argument("--warmup-epochs", type=float, default=0.0,
                    help="linear lr warmup into the cosine schedule (0: the plain cosine)")
    sp.add_argument("--zero-init-residual", action="store_true",
                    help="zero the last BN gamma of every residual block (resnet)")
    sp.set_defaults(fn=cmd_train)

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
                    help="weight_only_int4 and w4a8: rows of K that share a scale in dense "
                         "layers (0 = per-channel only)")
    sp.add_argument("--skip-first-layer", action="store_true",
                    help="static and w4a8: keep the stem in fp32, handing int8 on")
    sp.add_argument("--pre-add-quant", action="store_true",
                    help="static: quantize residual operands before the add in downsample blocks")
    sp.add_argument("--importance", default=None, choices=[None, "sensitivity", "static_map"],
                    help="optimized: the layer-importance source (default sensitivity)")
    sp.add_argument("--optimized-low-tier", default="weight_only", choices=["weight_only", "int4"],
                    help="optimized: the precision of the least sensitive layers")
    sp.add_argument("--adaround-steps", type=int, default=0,
                    help="learned-rounding steps on the sub-byte tiers (weight_only_int4, w4a8); "
                         "0 disables")
    sp.add_argument("--int4-guard", type=float, default=0.0,
                    help="sub-byte tiers: keep 8-bit weights where a layer's measured int4 damage "
                         "exceeds this multiple of the median (0 disables)")
    sp.add_argument("--equalize", action="store_true",
                    help="cross-layer equalization before quantizing (data-free)")
    sp.add_argument("--bias-correct", action="store_true",
                    help="empirical bias correction on the sub-byte tiers, after AdaRound")
    sp.set_defaults(fn=cmd_quantize)

    sp = sub.add_parser("qat", help="finetune through fake quantization -> qat / qat_w4a8 / qat_int4")
    common(sp)
    sp.add_argument("--epochs", type=int, default=2, help="finetune epochs, from the fp32 artifact")
    sp.add_argument("--lr", type=float, default=0.01, help="finetune lr (about 1/10 of training's)")
    train_recipe(sp)
    sp.add_argument("--observer", default="minmax",
                    choices=["minmax", "moving_average", "histogram", "mse"])
    sp.add_argument("--calibration-batches", type=int, default=16)
    sp.add_argument("--grad-clip-norm", type=float, default=1.0,
                    help="global-norm gradient clip of the finetune (0 disables)")
    sp.add_argument("--per-tensor", action="store_true", help="per-tensor weight fake quant")
    sp.add_argument("--skip-first-layer", action="store_true", help="keep the stem in fp32")
    sp.add_argument("--weight-bits", type=int, default=8, choices=[8, 4],
                    help="weight fake-quant width; 4 is sub-byte QAT")
    sp.add_argument("--weight-group-size", type=int, default=128,
                    help="rows of K that share a scale in 4-bit dense layers (0 = per channel)")
    sp.add_argument("--weight-only", action="store_true",
                    help="train and bake the weight_only_int4 contract (f32 activations, the "
                         "classifier f32) instead of W4A8")
    sp.add_argument("--init-from", default="",
                    help="start from this quantized artifact's weights, e.g. w4a8 or "
                         "weight_only_int4")
    sp.add_argument("--int4-guard", type=float, default=0.0,
                    help="keep 8-bit weights where a layer's measured int4 damage exceeds this "
                         "multiple of the median (0 disables)")
    sp.add_argument("--artifact-name", default="",
                    help="the saved artifact's name (default qat / qat_w4a8 / qat_int4)")
    sp.set_defaults(fn=cmd_qat)

    sp = sub.add_parser("evaluate", help="top-1 / top-5 / per-class of the artifacts")
    common(sp)
    sp.add_argument("--eval-batch-size", type=int, default=512)
    sp.add_argument("--models", default="",
                    help="comma-separated subset of artifacts (default: all on disk); "
                         "a subset merges into an existing accuracy.json")
    sp.add_argument("--per-class", action="store_true",
                    help="print per-class accuracy (top 20, sorted desc)")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("bench", help="latency, throughput and size on the card "
                                      "(--device cpu: the host clock)")
    common(sp)
    sp.add_argument("--batch-sizes", default="1,32,1024")
    sp.add_argument("--warmup", type=int, default=10)
    sp.add_argument("--iters", type=int, default=100)
    sp.add_argument("--s4-runtime", action="store_true",
                    help="pack the sub-byte tiers' 4-bit weights two to a byte in device memory "
                         "before benching (the same logits; half the weight bytes, the bs1 lever)")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("serve", help="a load test of the continuous-batching engine")
    common(sp)
    sp.add_argument("--scheme", default=None,
                    help="artifact to serve; when none is named, static, else any available")
    sp.add_argument("--requests", type=int, default=256)
    sp.add_argument("--buckets", default="1,8,32,128")
    sp.add_argument("--max-wait-ms", type=float, default=2.0)
    sp.add_argument("--data-parallel", type=int, default=1,
                    help="split each batch over this many local devices (-1: every card)")
    sp.add_argument("--wire", default="f32", choices=["f32", "u8"],
                    help="u8: raw uint8 payloads normalized on the device")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("report", help="the comparison table and the markdown report")
    common(sp)
    sp.add_argument("--report-batch-size", type=int, default=32)
    sp.set_defaults(fn=cmd_report)

    sp = sub.add_parser("scaling", help="weak scaling over the local cards -> scaling.json")
    common(sp)
    sp.add_argument("--per-device-batch", type=int, default=256)
    sp.add_argument("--iters", type=int, default=20)
    sp.set_defaults(fn=cmd_scaling)

    sp = sub.add_parser("experiment", help="train -> quantize all -> qat -> evaluate -> bench -> report",
                        epilog=NOT_PORTED)
    common(sp)
    sp.add_argument("--epochs", type=int, default=20)
    sp.add_argument("--lr", type=float, default=0.1)
    train_recipe(sp)
    sp.add_argument("--skip-training", action="store_true",
                    help="start from the fp32 artifact in --save-dir when there is one")
    sp.add_argument("--qat-epochs", type=int, default=2,
                    help="QAT finetune epochs after PTQ, at a tenth of --lr (0 disables)")
    sp.add_argument("--observer", default="minmax",
                    choices=["minmax", "moving_average", "histogram", "mse"])
    sp.add_argument("--calibration-batches", type=int, default=16)
    sp.add_argument("--adaround-steps", type=int, default=0,
                    help="learned-rounding steps on the sub-byte tiers (see quantize)")
    sp.add_argument("--int4-guard", type=float, default=0.0,
                    help="sub-byte tiers: keep 8-bit weights at outlier layers (see quantize)")
    sp.add_argument("--skip-first-layer", action="store_true",
                    help="static and w4a8: keep the stem in fp32, handing int8 on")
    sp.add_argument("--pre-add-quant", action="store_true",
                    help="static: quantize residual operands before the add in downsample blocks")
    sp.add_argument("--eval-batch-size", type=int, default=512)
    sp.add_argument("--batch-sizes", default="1,32,1024")
    sp.add_argument("--warmup", type=int, default=10)
    sp.add_argument("--iters", type=int, default=100)
    sp.add_argument("--report-batch-size", type=int, default=32)
    sp.add_argument("--warmup-epochs", type=float, default=0.0,
                    help="linear lr warmup into the cosine schedule (0: the plain cosine)")
    sp.add_argument("--zero-init-residual", action="store_true",
                    help="zero the last BN gamma of every residual block (resnet)")
    sp.set_defaults(fn=cmd_experiment)
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
