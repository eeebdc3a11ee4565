"""MobileNetV2 (counterpart of quantnet/models/mobilenet.py, inference).

Sandler et al. 2018 in torchvision's layout, width multiplier rounded to 8:
stem 3x3/2 -> 32, 17 inverted-residual blocks per the (t, c, n, s) table,
head 1x1 -> 1280, global average pool, dropout (the identity at inference),
fc. NHWC activations, HWIO weights; a depthwise kernel is HWIO (kh, kw, 1, C)
and runs with groups == C (ops/conv.py). Layer paths read 'conv_stem',
'block7/dw', 'block16/project', 'conv_head', 'fc', as the JAX package lays
the tree out, so a tree made there runs here.

The static-INT8 forward hands int8 tensors along, as the ResNet's does: the
stem and each expand, depthwise and non-residual project conv requantize
their output into the next static conv's domain (`_chain_aq`); a residual
block's project conv emits f32, the add runs in f32 with no activation (the
linear bottleneck) and the sum is quantized into the next block's domain.

Mirrored from the JAX package, on purpose: `_block_cin` reads the input
channels of a block's first conv, which for a t=1 block (block0, no expand)
is the depthwise kernel's I axis, 1. So block0's residual never fires, also
at widths where torchvision's would (width 0.25: stem and block0 both 8
wide). ROADMAP Queue 3 records it. With `train=True` the forward is
differentiable, batchnorm takes the batch's statistics and returns the new
running ones, and the head's dropout draws its mask from `generator`
(mobilenet.py:147-160,291).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from quantnet_torch.core.config import DEFAULT_FLAGS, Flags, resolve_device
from quantnet_torch.core.quantize import dequantize, fake_quant_act_ste, quantize_affine
from quantnet_torch.core.types import ActQuant
from quantnet_torch.models import batchnorm, capture_input, copy_dicts, state_slot
from quantnet_torch.ops.conv import conv2d
from quantnet_torch.ops.int8_matmul import activation
from quantnet_torch.ops.layers import avgpool_global, batchnorm_init, dropout
from quantnet_torch.ops.linear import linear

# (expansion t, output channels c, repeats n, first-block stride s): Sandler
# et al. 2018 Table 2, torchvision's inverted_residual_setting.
BLOCK_TABLE = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
STEM_WIDTH = 32
HEAD_WIDTH = 1280


def _divisible(v: float, divisor: int = 8) -> int:
    """torchvision's _make_divisible: a multiple of 8, never more than 10% below v."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def block_widths(width_mult: float = 1.0):
    """(stem, head, ((t, hidden, cout, stride), ...)) after the width multiplier."""
    stem = _divisible(STEM_WIDTH * width_mult)
    head = _divisible(HEAD_WIDTH * max(1.0, width_mult))
    blocks = []
    cin = stem
    for t, c, n, s in BLOCK_TABLE:
        cout = _divisible(c * width_mult)
        for i in range(n):
            blocks.append((t, cin * t, cout, s if i == 0 else 1))
            cin = cout
    return stem, head, tuple(blocks)


def _kaiming(generator, shape, fan_in: int, device) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * math.sqrt(2.0 / fan_in)).to(device)


def _conv_bn(generator, kh, kw, cin, cout, state_slot: dict, device, depthwise=False) -> dict:
    # A depthwise kernel's fan-in is kh * kw: each output channel reduces
    # over one input channel.
    fan = kh * kw * (1 if depthwise else cin)
    layer = {"w": _kaiming(generator, (kh, kw, 1 if depthwise else cin, cout), fan, device)}
    layer["bn"], bn_state = batchnorm_init(cout, device)
    state_slot.update(bn_state)
    return layer


def init(
    generator: Optional[torch.Generator] = None,
    *,
    num_classes: int = 1000,
    width_mult: float = 1.0,
    device="cuda",
) -> Tuple[dict, dict]:
    """Returns (params, state) on `device`, with BN running statistics in
    state. Weights are drawn from `generator` (a fresh one seeded 0 if None)
    on its own device, so a CPU generator gives the same weights on any
    device. Layer order comes from the paths' names (quantize/common.py's
    `_model_order_key`: conv_stem first, blocks in numeric order, fc last),
    not from dict order."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    stem, head, blocks = block_widths(width_mult)
    params: dict = {}
    state: dict = {"conv_stem": {}}
    params["conv_stem"] = _conv_bn(generator, 3, 3, 3, stem, state["conv_stem"], device)
    cin = stem
    for bi, (t, hidden, cout, _) in enumerate(blocks):
        bp: dict = {}
        bs: dict = {}
        if t != 1:
            bs["expand"] = {}
            bp["expand"] = _conv_bn(generator, 1, 1, cin, hidden, bs["expand"], device)
        bs["dw"] = {}
        bp["dw"] = _conv_bn(generator, 3, 3, hidden, hidden, bs["dw"], device, depthwise=True)
        bs["project"] = {}
        bp["project"] = _conv_bn(generator, 1, 1, hidden, cout, bs["project"], device)
        params[f"block{bi}"], state[f"block{bi}"] = bp, bs
        cin = cout
    state["conv_head"] = {}
    params["conv_head"] = _conv_bn(generator, 1, 1, cin, head, state["conv_head"], device)
    params["fc"] = {
        "w": _kaiming(generator, (head, num_classes), head, device),
        "b": torch.zeros(num_classes, device=device),
    }
    return params, state


def _conv_bn_act(layer, state, x, *, stride, padding, act, capture, path, flags, groups=1,
                 out_quant=None, slot=None):
    """Conv, then BN where the layer keeps it (`slot`, in train mode,
    receives the new running statistics), then the activation."""
    if "bn" in layer:
        y = conv2d(layer, x, stride=stride, padding=padding, groups=groups, flags=flags)
        return activation(batchnorm(layer["bn"], state, y, slot), act)
    # A depthwise conv is "dwconv": the replay takes its groups from the
    # input's channels, so every spec stays a 4-tuple.
    capture_input(capture, path, x, ("dwconv" if groups > 1 else "conv", stride, padding, act))
    return conv2d(layer, x, stride=stride, padding=padding, activation=act, groups=groups,
                  out_quant=out_quant, flags=flags)


def _chain_aq(producer: dict, consumer: Optional[dict]) -> Optional[ActQuant]:
    """The consumer's ActQuant when the int8 handoff applies: a static
    consumer and a BN-folded producer (resnet.py::_chain_aq's rule)."""
    if consumer is not None and "bn" not in producer and isinstance(consumer.get("aq"), ActQuant):
        return consumer["aq"]
    return None


def _block_names(params: dict) -> Tuple[str, ...]:
    # Numeric order (block2 before block10), whatever the dict order.
    return tuple(sorted((k for k in params if k.startswith("block")), key=lambda k: int(k[5:])))


def _first_conv(block: dict) -> dict:
    return block.get("expand", block["dw"])


def _block_cin(bp: dict) -> int:
    # The reference's reading, kept for parity: for a t=1 block the first
    # conv is the depthwise one, whose I axis is 1 (see the module docstring).
    return _first_conv(bp)["w"].shape[2]


def _block_cout(bp: dict) -> int:
    return bp["project"]["w"].shape[3]


def _block_stride_is_2(index: int) -> bool:
    """A block's stride from its position in BLOCK_TABLE, the same at every width."""
    strides = []
    for _, _, n, s in BLOCK_TABLE:
        strides.extend([s] + [1] * (n - 1))
    return strides[index] == 2


def apply(
    params: dict,
    state: dict,
    x: torch.Tensor,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    capture: Optional[dict] = None,
    torch_pad: bool = False,
    flags: Flags = DEFAULT_FLAGS,
) -> Tuple[torch.Tensor, dict]:
    """Forward on NHWC images. Returns (logits, state), the new state under
    `train` (the inference forward runs without autograd).

    torch_pad takes torch's symmetric (1, 1) padding at the stride-2 sites
    (the stem and the stride-2 depthwise convs) in place of XLA's SAME, which
    pads (0, 1) there: imported torchvision weights need it. `capture`, if
    given, receives every folded layer's input under its path (static
    calibration), and each op's spec under capture["__specs__"] when the
    caller seeds that dict.
    """
    if train:
        return _forward(params, state, x, True, generator, capture, torch_pad, flags)
    with torch.no_grad():
        return _forward(params, state, x, False, None, capture, torch_pad, flags)


def _forward(params, state, x, train, generator, capture, torch_pad, flags):
    new_state = copy_dicts(state) if train else None
    slot = functools.partial(state_slot, new_state)

    pad2 = ((1, 1), (1, 1)) if torch_pad else "SAME"
    names = _block_names(params)
    x = _conv_bn_act(
        params["conv_stem"], state.get("conv_stem", {}), x, stride=2, padding=pad2, act="relu6",
        capture=capture, path="conv_stem", flags=flags, slot=slot("conv_stem"),
        out_quant=_chain_aq(params["conv_stem"], _first_conv(params[names[0]])) if names else None,
    )
    for i, name in enumerate(names):
        bp, bs = params[name], state.get(name, {})
        hidden = bp["dw"]["w"].shape[3]
        stride = 2 if _block_stride_is_2(i) else 1
        residual = stride == 1 and _block_cin(bp) == _block_cout(bp)
        identity = x
        if residual and x.dtype == torch.int8:
            # The block's int8 input lies in its first conv's domain; the
            # identity takes it dequantized (only where the add reads it).
            a = _first_conv(bp)["aq"]
            identity = dequantize(x, a.scale, a.zero_point)
        elif residual and flags.fake_quant_identity and _first_conv(bp).get("fq") is not None:
            fq = _first_conv(bp)["fq"]
            if fq.act_quant:
                identity = fake_quant_act_ste(x, fq.scale, fq.zero_point)
        h = x
        if "expand" in bp:
            h = _conv_bn_act(
                bp["expand"], bs.get("expand", {}), h, stride=1, padding="VALID", act="relu6",
                capture=capture, path=f"{name}/expand", flags=flags, slot=slot(name, "expand"),
                out_quant=_chain_aq(bp["expand"], bp["dw"]),
            )
        h = _conv_bn_act(
            bp["dw"], bs.get("dw", {}), h, stride=stride, padding=pad2 if stride == 2 else "SAME",
            act="relu6", capture=capture, path=f"{name}/dw", flags=flags, groups=hidden,
            slot=slot(name, "dw"),
            out_quant=_chain_aq(bp["dw"], bp["project"]),
        )
        nxt = _first_conv(params[names[i + 1]]) if i + 1 < len(names) else params["conv_head"]
        boundary_aq = _chain_aq(bp["project"], nxt)
        # The linear bottleneck: no activation on the projection or the add. A
        # residual block's projection emits f32 for the add.
        h = _conv_bn_act(
            bp["project"], bs.get("project", {}), h, stride=1, padding="VALID", act=None,
            capture=capture, path=f"{name}/project", flags=flags, slot=slot(name, "project"),
            out_quant=None if residual else boundary_aq,
        )
        if residual:
            x = h + identity
            if boundary_aq is not None:
                x = quantize_affine(x, boundary_aq.scale, boundary_aq.zero_point)
        else:
            x = h
    x = _conv_bn_act(
        params["conv_head"], state.get("conv_head", {}), x, stride=1, padding="VALID",
        act="relu6", capture=capture, path="conv_head", flags=flags, slot=slot("conv_head"),
    )
    x = dropout(avgpool_global(x), 0.2, generator)
    capture_input(capture, "fc", x, ("linear", None, None, None))
    return linear(params["fc"], x, flags=flags), new_state if train else state
