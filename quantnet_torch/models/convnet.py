"""SimpleConvNet (counterpart of quantnet/models/convnet.py:30-184).

Three blocks of [Conv3x3 -> BN -> ReLU] x 2 -> MaxPool2 -> Dropout with
widths 64/128/256, then Flatten -> FC(4096->512) -> BN1d -> ReLU -> Dropout ->
FC(512->10). Parameters are nested dicts of tensors laid out as the JAX
package lays them out (HWIO convs, (K, N) dense weights), and images enter
NHWC as f32[N, 32, 32, 3], so the fc1 flatten order is (H, W, C).

`apply` is the forward: with BN (the fp32 model) or BN-folded (the
quantized model, activation fused into each op's epilogue), under every
scheme: fp32, bf16, weight-only, dynamic and static INT8, and QAT's
fake-quantized islands. On the static path each layer hands its successor
int8 in the successor's frozen domain (`_chain_plan`), and `capture` records
the quantized layers' inputs for calibration, with each op's spec under
`__specs__` when the caller seeds it (models.capture_input). With
`train=True` it is differentiable: batchnorm normalizes with the batch's
statistics and returns the new running ones, and dropout draws its masks
from `generator` (none without one, as in the JAX package without an rng).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from quantnet_torch.core.config import DEFAULT_FLAGS, Flags, resolve_device
from quantnet_torch.core.types import ActQuant
from quantnet_torch.models import batchnorm, capture_input, copy_dicts, state_slot
from quantnet_torch.ops.conv import conv2d
from quantnet_torch.ops.layers import batchnorm_init, dropout, maxpool2d
from quantnet_torch.ops.linear import linear

CONV_DEFS = [
    ("conv1", 3, 64),
    ("conv2", 64, 64),
    ("conv3", 64, 128),
    ("conv4", 128, 128),
    ("conv5", 128, 256),
    ("conv6", 256, 256),
]
QUANT_LAYERS = [name for name, _, _ in CONV_DEFS] + ["fc1", "fc2"]
FC_DIM = 512


def _kaiming(generator: torch.Generator, shape, fan_in: int, device) -> torch.Tensor:
    # Kaiming-normal, fan-in, relu gain.
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * math.sqrt(2.0 / fan_in)).to(device)


def init(
    generator: Optional[torch.Generator] = None,
    *,
    num_classes: int = 10,
    image_size: int = 32,
    device="cuda",
) -> Tuple[dict, dict]:
    """Returns (params, state) on `device`; state holds BN running stats.

    Weights are drawn from `generator` (a fresh one seeded 0 if None) on the
    generator's device, so a CPU generator gives the same weights on any
    device.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params, state = {}, {}
    for name, cin, cout in CONV_DEFS:
        params[name] = {
            "w": _kaiming(generator, (3, 3, cin, cout), 9 * cin, device),
            "b": torch.zeros(cout, device=device),
        }
        params[name]["bn"], state[name] = batchnorm_init(cout, device)
    feat = (image_size // 8) ** 2 * CONV_DEFS[-1][2]
    params["fc1"] = {
        "w": _kaiming(generator, (feat, FC_DIM), feat, device),
        "b": torch.zeros(FC_DIM, device=device),
    }
    params["fc1"]["bn"], state["fc1"] = batchnorm_init(FC_DIM, device)
    params["fc2"] = {
        "w": _kaiming(generator, (FC_DIM, num_classes), FC_DIM, device),
        "b": torch.zeros(num_classes, device=device),
    }
    return params, state


def _chain_plan(params: dict) -> dict:
    """The static path's int8 handoff plan: layer -> its successor's ActQuant
    (quantnet/models/convnet.py:79-101). Between consecutive quantized
    layers lie only relu, maxpool, inference dropout and the flatten, which
    are monotone or the identity, so requantizing at the producer gives the
    consumer the same int8 input. Any producer can requantize (every op
    honours out_quant: fp32 / bf16 islands and weight-only layers too) once
    it is BN-folded, into a consumer that holds a frozen ActQuant."""
    plan = {}
    for i, name in enumerate(QUANT_LAYERS[:-1]):
        cur, nxt = params.get(name), params.get(QUANT_LAYERS[i + 1])
        if cur is not None and nxt is not None and "bn" not in cur and isinstance(nxt.get("aq"), ActQuant):
            plan[name] = nxt["aq"]
    return plan


def _conv_bn_relu(params, state, new_state, name, x, flags, capture, out_quant):
    layer = params[name]
    if "bn" in layer:
        x = conv2d(layer, x, flags=flags)
        return torch.relu(batchnorm(layer["bn"], state[name], x, state_slot(new_state, name)))
    capture_input(capture, name, x, ("conv", 1, "SAME", "relu"))
    return conv2d(layer, x, activation="relu", out_quant=out_quant, flags=flags)


def apply(
    params: dict,
    state: dict,
    x: torch.Tensor,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    flags: Flags = DEFAULT_FLAGS,
    capture: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    """Forward on NHWC images. Returns (logits, state), the new state under
    `train` (the inference forward runs without autograd).

    `capture`, when a dict is given, receives each quantized layer's input
    on the BN-folded path: what static calibration observes; and each op's
    spec under capture["__specs__"] when the caller seeds that dict.
    """
    if train:
        return _forward(params, state, x, True, generator, flags, capture)
    with torch.no_grad():
        return _forward(params, state, x, False, None, flags, capture)


def _forward(params, state, x, train, generator, flags, capture):
    new_state = copy_dicts(state) if train else None
    chain = _chain_plan(params)
    for block in (("conv1", "conv2"), ("conv3", "conv4"), ("conv5", "conv6")):
        for name in block:
            x = _conv_bn_relu(params, state, new_state, name, x, flags, capture, chain.get(name))
        x = dropout(maxpool2d(x), 0.25, generator)

    x = x.reshape(x.shape[0], -1)
    fc1 = params["fc1"]
    if "bn" in fc1:
        x = linear(fc1, x, flags=flags)
        x = torch.relu(batchnorm(fc1["bn"], state["fc1"], x, state_slot(new_state, "fc1")))
    else:
        capture_input(capture, "fc1", x, ("linear", None, None, "relu"))
        x = linear(fc1, x, activation="relu", out_quant=chain.get("fc1"), flags=flags)
    x = dropout(x, 0.5, generator)
    capture_input(capture, "fc2", x, ("linear", None, None, None))
    return linear(params["fc2"], x, flags=flags), new_state if train else state
