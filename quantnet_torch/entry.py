"""Entry points (counterpart of __graft_entry__.entry): an inference step of
one deployment, with its example inputs.

    fn, args = entry()          # dynamic-INT8 SimpleConvNet, bs32
    fn, args = static_entry()   # static-INT8 SimpleConvNet, bs1024
    fn, args = resnet_entry()   # static-INT8 ResNet-50, bs128, 224x224
    logits = fn(*args)
"""
from __future__ import annotations

import torch

from quantnet_torch.core.config import resolve_device
from quantnet_torch.models import convnet, resnet
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
):
    """Returns (fn, (qparams, qstate, images)) for the static-INT8 ResNet
    deployment that the JAX package measures (scripts/tpu_boundary_pallas_bench.py):
    random weights from `seed` (1000 classes), BN folded, min-max calibration
    on one seeded batch of `calibration_size` images, per-channel int8
    weights, the fp32 stem handing int8 to the next layer
    (skip_first_layer=True), no pre-add quantization."""
    device = resolve_device(device)
    params, state = resnet.init(torch.Generator().manual_seed(seed), depth=depth, device=device)
    shape = (calibration_size, image_size, image_size, 3)
    calib = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1)).to(device)
    qparams, qstate = static.quantize(params, state, resnet.apply, [calib], skip_first_layer=True)
    shape = (batch_size, image_size, image_size, 3)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 2)).to(device)

    def fn(qparams, qstate, images):
        logits, _ = resnet.apply(qparams, qstate, images)
        return logits

    return fn, (qparams, qstate, x)
