"""Entry points (counterpart of __graft_entry__.py): an inference step of
one deployment, with its example inputs, and the multi-rank dry run.

    fn, args = entry()          # dynamic-INT8 SimpleConvNet, bs32
    fn, args = static_entry()   # static-INT8 SimpleConvNet, bs1024
    fn, args = resnet_entry()   # static-INT8 ResNet-50, bs128, 224x224
    fn, args = mobilenet_entry()  # static-INT8 MobileNetV2, bs256, 224x224
    logits = fn(*args)
    dryrun_multichip(4)         # a (data 2 x model 2) process mesh
"""
from __future__ import annotations

import hashlib
import queue
import socket
import time
from typing import Optional

import torch

from quantnet_torch.core.config import resolve_device
from quantnet_torch.models import convnet, mobilenet, resnet
from quantnet_torch.quantize import dynamic, static


def entry(device="cuda", batch_size: int = 32):
    """Returns (fn, (qparams, qstate, images)); dynamic INT8 with a bf16
    inter-layer handoff, the same deployment as the JAX package's bench.py."""
    device = resolve_device(device)
    params, state = convnet.init(torch.Generator().manual_seed(0), device=device)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((batch_size, 32, 32, 3), generator=g).to(device)
    qparams, qstate = dynamic.quantize(params, state)

    def fn(qparams, qstate, images):
        logits, _ = convnet.apply(qparams, qstate, images)
        return logits

    return fn, (qparams, qstate, x)


def static_entry(
    device="cuda",
    *,
    batch_size: int = 1024,
    calibration_size: int = 32,
    skip_first_layer: bool = True,
    seed: int = 0,
):
    """Returns (fn, (qparams, qstate, images)) for the static-INT8 sibling
    of the convnet deployment: random weights from `seed`, BN folded, min-max
    calibration on one seeded batch of `calibration_size` images, per-channel
    int8 weights, every layer handing int8 to the next in its frozen domain,
    the fp32 stem by default."""
    device = resolve_device(device)
    params, state = convnet.init(torch.Generator().manual_seed(seed), device=device)
    shape = (calibration_size, 32, 32, 3)
    calib = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1)).to(device)
    qparams, qstate = static.quantize(
        params, state, convnet.apply, [calib], skip_first_layer=skip_first_layer
    )
    x = torch.randn((batch_size, 32, 32, 3), generator=torch.Generator().manual_seed(seed + 2)).to(device)

    def fn(qparams, qstate, images):
        logits, _ = convnet.apply(qparams, qstate, images)
        return logits

    return fn, (qparams, qstate, x)


def resnet_entry(
    device="cuda",
    *,
    depth: int = 50,
    batch_size: int = 128,
    image_size: int = 224,
    calibration_size: int = 32,
    seed: int = 0,
    s2d: bool = False,
    skip_first_layer: bool = True,
):
    """Returns (fn, (qparams, qstate, images)) for the static-INT8 ResNet
    deployment that the JAX package measures (scripts/tpu_boundary_pallas_bench.py):
    random weights from `seed` (1000 classes), BN folded, min-max calibration
    on one seeded batch of `calibration_size` images, per-channel int8
    weights, the fp32 stem handing int8 to the next layer
    (skip_first_layer=True), no pre-add quantization. `s2d` folds the stem
    into its space-to-depth form first (resnet.fold_stem_s2d)."""
    device = resolve_device(device)
    params, state = resnet.init(torch.Generator().manual_seed(seed), depth=depth, device=device)
    if s2d:
        params = resnet.fold_stem_s2d(params)
    shape = (calibration_size, image_size, image_size, 3)
    calib = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1)).to(device)
    qparams, qstate = static.quantize(params, state, resnet.apply, [calib],
                                      skip_first_layer=skip_first_layer)
    shape = (batch_size, image_size, image_size, 3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 2)).to(device)

    def fn(qparams, qstate, images):
        logits, _ = resnet.apply(qparams, qstate, images)
        return logits

    return fn, (qparams, qstate, x)


def mobilenet_entry(
    device="cuda",
    *,
    scheme: str = "static",
    batch_size: int = 256,
    image_size: int = 224,
    calibration_size: int = 32,
    seed: int = 0,
):
    """Returns (fn, (qparams, qstate, images)) for MobileNetV2 1.0 (1000
    classes) at the size the JAX package benchmarks it (224x224, bs256;
    docs/results_tpu_v5e_mobilenet_224): random weights from `seed`, BN
    folded, then `scheme` "static" (min-max calibration on one seeded batch
    of `calibration_size` images, per-channel int8 weights, the int8 stem,
    every conv handing int8 to the next) or "dynamic" (per-batch activation
    scales, the bf16 handoff, the fc through the fused dynamic GEMM)."""
    device = resolve_device(device)
    params, state = mobilenet.init(torch.Generator().manual_seed(seed), device=device)
    if scheme == "static":
        shape = (calibration_size, image_size, image_size, 3)
        calib = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1)).to(device)
        qparams, qstate = static.quantize(params, state, mobilenet.apply, [calib])
    elif scheme == "dynamic":
        qparams, qstate = dynamic.quantize(params, state)
    else:
        raise ValueError(f"scheme must be 'static' or 'dynamic', got {scheme!r}")
    shape = (batch_size, image_size, image_size, 3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 2)).to(device)

    def fn(qparams, qstate, images):
        logits, _ = mobilenet.apply(qparams, qstate, images)
        return logits

    return fn, (qparams, qstate, x)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda", timeout_s: float = 900.0) -> dict:
    """The JAX package's multi-chip dry run (__graft_entry__.py:35-180) on a
    process mesh of `n_devices` spawned ranks: (data n/2 x model 2) when n
    is even and at least 4, else (n x 1); each rank on a card of its own
    where there are enough (NCCL), else on `[device] * n` (gloo, the ranks
    sharing a card, or the CPU). In the JAX order, on the mesh: one fp32
    train step and an eval step; static INT8 and W4A8 quantized from the
    gathered logical tree, sharded and evaluated; a sharded W4 QAT step, its
    bake and an eval; a static MobileNetV2 (width 0.5) eval; then, on rank 0
    over a local mesh the size of the data axis, 200 requests through the
    serving engine and one pass of the scaling harness. Rank 0 prints the
    JAX line, with the same keys; where the ranks share a card or run on
    the CPU the scaling field says correctness-only and gives no
    efficiency. Returns rank 0's results (the line, the losses, the counts,
    the gathered params and state after the first step, as numpy, and every
    rank's digest of its replicated leaves after it). A rank that fails, or
    a run longer than `timeout_s`, raises, and every rank is stopped."""
    device = resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_dryrun_rank, args=(r, n_devices, port, device.type, results))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            try:
                result = results.get(timeout=1.0)
                break
            except queue.Empty:
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    raise RuntimeError(f"dryrun_multichip: ranks {failed} failed" if failed else
                                       f"dryrun_multichip: no result in {timeout_s} s") from None
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if isinstance(result, BaseException):
        raise RuntimeError("a rank of dryrun_multichip failed") from result
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip: ranks {failed} failed")
    return result


def _dryrun_rank(rank: int, world: int, port: int, device: str, results) -> None:
    """One rank of dryrun_multichip; rank 0 puts its results (or its error)
    on `results`."""
    try:
        out = _dryrun_body(rank, world, port, device)
    except BaseException as e:  # noqa: BLE001 - handed to the parent, which raises
        if rank == 0:
            results.put(e)
        raise
    if rank == 0:
        results.put(out)


def _dryrun_body(rank: int, world: int, port: int, device: str) -> Optional[dict]:
    import numpy as np
    import torch.distributed as dist

    from quantnet_torch.bench.scaling import measure_scaling
    from quantnet_torch.core.config import TrainConfig
    from quantnet_torch.parallel import mesh as meshlib
    from quantnet_torch.parallel.steps import eval_step, train_step
    from quantnet_torch.parallel.tensor import gather_params, shard_params, sharded_leaves
    from quantnet_torch.quantize import qat
    from quantnet_torch.serve import InferenceEngine
    from quantnet_torch.train.trainer import Optimizer, clone_tree, tensor_leaves

    if device == "cpu":
        torch.set_num_threads(1)  # the CPU ranks share the host's cores
    dev = meshlib.init_distributed(f"localhost:{port}", world, rank, device=device)
    mp = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = meshlib.make_mesh(world // mp, mp)
    split = mp > 1

    def step(params, state, seed):
        """One train step of a sharded tree -> (params, state, loss)."""
        p = clone_tree(params, requires_grad=True)
        leaves = tensor_leaves(p)
        opt = Optimizer(cfg, 1)
        new_state, loss, _ = train_step(mesh, convnet.apply, opt, p, state, opt.init(leaves),
                                        leaves, torch.Generator().manual_seed(seed), im, lb)
        return clone_tree(p), new_state, float(loss)

    def evaluate(apply_fn, params, state):
        c = eval_step(mesh, apply_fn, params, state, im, lb)
        return c["top1"], c["n"]

    params, state = convnet.init(torch.Generator().manual_seed(0), device=dev)
    cfg = TrainConfig(epochs=1, batch_size=2 * world, lr=0.1)
    images = torch.zeros((2 * world, 32, 32, 3), device=dev)
    labels = torch.zeros((2 * world,), dtype=torch.int64, device=dev)
    im, lb = meshlib.shard_batch(mesh, (images, labels))
    p, s, loss = step(shard_params(mesh, params, model_parallel=split),
                      shard_params(mesh, state, model_parallel=split), 1)
    top1, n = evaluate(convnet.apply, p, s)
    logical = (gather_params(mesh, p), gather_params(mesh, s))
    # Every rank's replicated leaves after the step, by digest (the same bits
    # on every rank of the mesh).
    replicated = [t for t, sp in zip(tensor_leaves(p), sharded_leaves(p, split)) if not sp]
    digests = meshlib.gather_objects(hashlib.sha256(b"".join(
        t.detach().cpu().numpy().tobytes() for t in replicated)).hexdigest())

    # The deployed tiers, quantized from the logical tree and sharded.
    results = {}
    for name, kwargs in (("static_int8", {}), ("w4a8", {"weight_bits": 4, "weight_group_size": 128})):
        qparams, qstate = static.quantize(*logical, convnet.apply, [images], skip_first_layer=True,
                                          **kwargs)
        results[name] = evaluate(convnet.apply, shard_params(mesh, qparams, model_parallel=split),
                                 shard_params(mesh, qstate, model_parallel=split))[0]

    # A sharded W4 QAT step, its bake (of the gathered tree) and an eval.
    fq_p, fq_s = qat.prepare(*logical, convnet.apply, [images], weight_bits=4,
                             weight_group_size=128, skip_first_layer=True)
    fq_p, fq_s, qat_loss = step(shard_params(mesh, fq_p, model_parallel=split),
                                shard_params(mesh, fq_s, model_parallel=split), 2)
    baked = shard_params(mesh, qat.bake(gather_params(mesh, fq_p)), model_parallel=split)
    qat1, qatn = evaluate(convnet.apply, baked, fq_s)

    # MobileNetV2 (width 0.5), static INT8, batch-sharded over the data axis.
    mn_p, mn_s = mobilenet.init(torch.Generator().manual_seed(3), num_classes=10, width_mult=0.5,
                                device=dev)
    mn_qp, mn_qs = static.quantize(mn_p, mn_s, mobilenet.apply, [images], skip_first_layer=True)
    mn1, mnn = evaluate(mobilenet.apply, shard_params(mesh, mn_qp), shard_params(mesh, mn_qs))
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return None

    # Serving and the scaling harness: one process over a local mesh the
    # size of the data axis (the W4A8 tree, as the JAX run serves it).
    local = [dev] * mesh.size
    n_req = 200
    with InferenceEngine(convnet.apply, qparams, qstate, buckets=(world, 4 * world), max_wait_ms=1.0,
                         mesh=meshlib.make_mesh(mesh.size, devices=local)) as engine:
        img = np.zeros((32, 32, 3), np.float32)
        futs = [engine.submit(img) for _ in range(n_req)]
        for f in futs:
            assert f.result(timeout=120).shape == (10,)
        served = int(engine.stats["requests"])
        occupancy = engine.occupancy()
    scal = measure_scaling(convnet.apply, qparams, qstate, per_device_batch=8,
                           mesh_sizes=(1, mesh.size), iters=3, windows=1, devices=local)
    shared = dev.type == "cpu" or len(set(local)) < len(local)
    eff_str = ("scaling_harness=ok(shared-device mesh, compute-oversubscribed; correctness-only — "
               "efficiency not meaningful)" if shared
               else f"scaling_eff_{mesh.size}dev={scal['efficiency'][mesh.size]:.2f}")
    line = (f"dryrun_multichip ok: mesh={mesh.shape} loss={loss:.4f} "
            f"int8_eval_top1={results['static_int8']}/{n} w4a8_eval_top1={results['w4a8']}/{n} "
            f"qat_w4_step_loss={qat_loss:.4f} qat_w4_eval_top1={qat1}/{qatn} "
            f"mobilenet_int8_eval_top1={mn1}/{mnn} serve_reqs={served}/{n_req} "
            f"occupancy={occupancy:.2f} {eff_str}")
    print(line, flush=True)
    # numpy, so the tree is pickled by value (a tensor would go through
    # shared memory that this process frees when it exits).
    def cpu(t):
        return t.detach().cpu().numpy()

    return {"line": line, "mesh": mesh.shape, "loss": loss, "qat_loss": qat_loss,
            "eval": (top1, n), "served": served, "n_req": n_req, "replicated_digests": digests,
            "params": meshlib.map_tensors(logical[0], cpu),
            "state": meshlib.map_tensors(logical[1], cpu)}
