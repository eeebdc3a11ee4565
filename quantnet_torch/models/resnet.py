"""ResNet, every torchvision depth (counterpart of quantnet/models/resnet.py:
31-127 and 130-472, inference).

Stem 7x7/2 + maxpool 3x3/2, four stages of basic (18/34) or bottleneck
(50/101/152) blocks, global average pool, fc. NHWC activations, HWIO
weights, nested-dict params whose layer paths read like 'layer3/2/conv2',
laid out as the JAX package lays them out, so a tree baked there runs here.

The static-INT8 forward hands int8 tensors along: each conv requantizes its
output into the next static conv's domain (`_chain_aq`), and at a block
boundary the residual add, relu and requantize run in one pass, the
residual_boundary kernel (ops/residual_boundary.py). The space-to-depth
stem (`fold_stem_s2d`, the MLPerf trick) rewrites the 7x7/2 stem as a 4x4/1
conv over 12 channels: K = 192 for the int8 GEMM instead of 147. With
`train=True` the forward is differentiable, batchnorm takes the batch's
statistics and returns the new running ones (resnet.py:271-312), and the
block boundary runs in PyTorch ops (the kernel has no backward; the JAX
package skips it under train too).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from quantnet_torch.core.config import DEFAULT_FLAGS, Flags, resolve_device
from quantnet_torch.core.quantize import dequantize, fake_quant_act_ste, quantize_affine
from quantnet_torch.core.types import ActQuant
from quantnet_torch.models import batchnorm, capture_input, copy_dicts, state_slot
from quantnet_torch.ops.conv import conv2d
from quantnet_torch.ops.layers import avgpool_global, batchnorm_init, wants_grad
from quantnet_torch.ops.linear import linear
from quantnet_torch.ops.residual_boundary import residual_boundary, residual_boundary_plain

STAGE_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
VARIANTS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _conv_init(generator, kh, kw, cin, cout, device) -> dict:
    # Kaiming-normal, fan-in, relu gain.
    w = torch.randn((kh, kw, cin, cout), generator=generator, device=generator.device)
    return {"w": (w * math.sqrt(2.0 / (kh * kw * cin))).to(device)}


def _with_bn(layer: dict, cout: int, state_slot: dict, device) -> dict:
    layer["bn"], bn_state = batchnorm_init(cout, device)
    state_slot.update(bn_state)
    return layer


def init(
    generator: Optional[torch.Generator] = None,
    *,
    num_classes: int = 1000,
    depth: int = 50,
    zero_init_residual: bool = False,
    device="cuda",
) -> Tuple[dict, dict]:
    """Returns (params, state) on `device` for any depth in VARIANTS; state
    holds the BN running statistics. Weights are drawn from `generator` (a
    fresh one seeded 0 if None) on its own device, so a CPU generator gives the
    same weights on any device. Downsample convs sit where torchvision puts
    them: in a stage's first block when the stride or the width changes.
    zero_init_residual zeroes each block's last BN gamma (torchvision's
    option): every residual branch starts as the identity."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    kind, stages = VARIANTS[depth]
    expansion = EXPANSION if kind == "bottleneck" else 1
    params: dict = {}
    state: dict = {"conv1": {}}
    params["conv1"] = _with_bn(_conv_init(generator, 7, 7, 3, 64, device), 64, state["conv1"], device)
    cin = 64
    for si, (blocks, width) in enumerate(zip(stages, STAGE_WIDTHS)):
        stage = f"layer{si + 1}"
        params[stage], state[stage] = {}, {}
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            cout = width * expansion
            if kind == "bottleneck":
                convs = [("conv1", 1, cin, width), ("conv2", 3, width, width), ("conv3", 1, width, cout)]
            else:
                convs = [("conv1", 3, cin, width), ("conv2", 3, width, cout)]
            if bi == 0 and (stride != 1 or cin != cout):
                convs.append(("downsample", 1, cin, cout))
            bp, bs = {}, {}
            for name, k, ci, co in convs:
                bs[name] = {}
                bp[name] = _with_bn(_conv_init(generator, k, k, ci, co, device), co, bs[name], device)
            if zero_init_residual:
                last = bp["conv3" if kind == "bottleneck" else "conv2"]["bn"]
                last["gamma"] = torch.zeros_like(last["gamma"])
            params[stage][str(bi)], state[stage][str(bi)] = bp, bs
            cin = cout
    w = torch.randn((cin, num_classes), generator=generator, device=generator.device)
    params["fc"] = {
        "w": (w * math.sqrt(2.0 / cin)).to(device),
        "b": torch.zeros(num_classes, device=device),
    }
    return params, state


def _conv_bn(layer, state, x, *, stride, padding, relu, capture, path, out_quant, flags, slot=None):
    """Conv, then BN where the layer keeps it; `slot` (train mode) receives
    the new running statistics."""
    if "bn" in layer:
        y = conv2d(layer, x, stride=stride, padding=padding, flags=flags)
        y = batchnorm(layer["bn"], state, y, slot)
        return torch.relu(y) if relu else y
    capture_input(capture, path, x, ("conv", stride, padding, "relu" if relu else None))
    return conv2d(
        layer, x, stride=stride, padding=padding, activation="relu" if relu else None,
        out_quant=out_quant, flags=flags,
    )


def _chain_aq(producer: dict, consumer: dict) -> Optional[ActQuant]:
    """The consumer's ActQuant when the int8 handoff applies: a static
    consumer and a BN-folded producer of any precision."""
    if "bn" not in producer and isinstance(consumer.get("aq"), ActQuant):
        return consumer["aq"]
    return None


def _stage_sizes(params: dict) -> Tuple[int, ...]:
    return tuple(len(params[f"layer{i + 1}"]) for i in range(4))


def _next_conv1(params: dict, si: int, bi: int) -> Optional[dict]:
    """conv1 of the block that takes this block's output; None after the last."""
    stages = _stage_sizes(params)
    if bi + 1 < stages[si]:
        return params[f"layer{si + 1}"][str(bi + 1)]["conv1"]
    if si + 1 < len(stages):
        return params[f"layer{si + 2}"]["0"]["conv1"]
    return None


def fold_stem_s2d(params: dict) -> dict:
    """The 7x7/stride-2 stem as a 4x4/stride-1 conv over a space-to-depth
    input (quantnet/models/resnet.py:188-218), the same function: output
    pixel o of the stride-2 conv taps padded input rows 2o + j, which in 2x2
    blocks are blocks o..o+3 at phase j % 2, so the 7x7xC kernel, zero-padded
    to 8x8, regroups into 4x4x4C. Run it on the fp32 weight, before any
    quantize transform (BN and the transforms apply unchanged after it)."""
    conv1 = dict(params["conv1"])
    w = conv1["w"]
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"stem fold expects a 7x7 stem, got {tuple(w.shape)}")
    wp = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))  # 8x8
    wp = wp.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * cin, cout)
    conv1["w"] = wp.contiguous()
    out = dict(params)
    out["conv1"] = conv1
    return out


def stem_s2d_input(x: torch.Tensor) -> torch.Tensor:
    """NHWC images -> the space-to-depth input of a folded stem
    (quantnet/models/resnet.py:221-250): zero pads with the leading pad of
    XLA's SAME for the 7x7/2 stem and a trailing pad that covers the zero 8th
    tap and makes the size even, then 2x2 blocks into channels. Data
    movement only."""
    n, h, w, c = x.shape

    def pads(size):
        out_size = -(-size // 2)
        total = max((out_size - 1) * 2 + 7 - size, 0)
        pt = total // 2
        return pt, max(2 * (out_size - 1) + 8 - size - pt, 0)

    (pt, pb), (pl, pr) = pads(h), pads(w)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    hh, ww = xp.shape[1] // 2, xp.shape[2] // 2
    return xp.reshape(n, hh, 2, ww, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, hh, ww, 4 * c)


def _stem_is_s2d(conv1: dict) -> bool:
    # A folded stem is 4x4 (fold_stem_s2d); every stock stem is 7x7.
    return conv1["w"].shape[0] == 4


def _maxpool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch's MaxPool2d(3, stride=2, padding=1) on NHWC, padding with -inf,
    or with int8's minimum on the int8 handoff path (resnet.py:253-263)."""
    if wants_grad(x):
        # Its gradient to a window's first maximum, as JAX's reduce_window.
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
    lo = float("-inf") if x.is_floating_point() else torch.iinfo(x.dtype).min
    x = F.pad(x, (0, 0, 1, 1, 1, 1), value=lo)
    return x.unfold(1, 3, 2).unfold(2, 3, 2).amax(dim=(-2, -1))


def apply(
    params: dict,
    state: dict,
    x: torch.Tensor,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    capture: Optional[dict] = None,
    conv1_scale: float = 1.0,
    torch_pad: bool = False,
    flags: Flags = DEFAULT_FLAGS,
) -> Tuple[torch.Tensor, dict]:
    """Forward on NHWC images. Returns (logits, state), the new state under
    `train` (the inference forward runs without autograd). `generator` is
    accepted for the trainer's sake: the ResNet has no dropout.

    conv1_scale multiplies the stem input. torch_pad takes torch's symmetric
    padding at the stride-2 sites (stem (3, 3), 3x3 convs (1, 1)) in place of
    XLA's SAME, which pads those asymmetrically. A folded stem
    (fold_stem_s2d) takes raw NHWC images, space-to-depthed here on the
    device, or images already in that form (4x the channels). `capture`, if given,
    receives every folded layer's input under its path, and for downsample
    blocks the pre-add outputs under '<path>:out' (static calibration); each
    op's spec under capture["__specs__"] when the caller seeds that dict.
    """
    if train:
        return _forward(params, state, x, True, capture, conv1_scale, torch_pad, flags)
    with torch.no_grad():
        return _forward(params, state, x, False, capture, conv1_scale, torch_pad, flags)


def _forward(params, state, x, train, capture, conv1_scale, torch_pad, flags):
    new_state = copy_dicts(state) if train else None
    slot = functools.partial(state_slot, new_state)

    pad3 = ((1, 1), (1, 1)) if torch_pad else "SAME"
    pad_stem = ((3, 3), (3, 3)) if torch_pad else "SAME"
    boundary = residual_boundary_plain if flags.plain else residual_boundary
    if conv1_scale != 1.0:
        x = x * conv1_scale
    stem = params["conv1"]
    s2d = _stem_is_s2d(stem)
    if s2d and stem["w"].shape[2] == 4 * x.shape[-1]:
        x = stem_s2d_input(x)
    x = _conv_bn(
        stem, state.get("conv1", {}), x, stride=1 if s2d else 2,
        padding="VALID" if s2d else pad_stem, relu=True,
        capture=capture, path="conv1", out_quant=_chain_aq(stem, params["layer1"]["0"]["conv1"]),
        flags=flags, slot=slot("conv1"),
    )
    x = _maxpool_3x3_s2(x)

    stages = _stage_sizes(params)
    for si in range(len(stages)):
        stage = f"layer{si + 1}"
        for bi in range(stages[si]):
            bp = params[stage][str(bi)]
            bs = state.get(stage, {}).get(str(bi), {})
            stride = 2 if (bi == 0 and si > 0) else 1
            prefix = f"{stage}/{bi}"
            bottleneck = "conv3" in bp
            last = "conv3" if bottleneck else "conv2"
            block_in = x  # int8 in conv1's domain when the boundary handed off

            def dequant_in():
                # The identity branch reads an int8 block input dequantized.
                if block_in.dtype != torch.int8:
                    fq = bp["conv1"].get("fq")
                    if flags.fake_quant_identity and fq is not None and fq.act_quant:
                        return fake_quant_act_ste(block_in, fq.scale, fq.zero_point)
                    return block_in
                a = bp["conv1"]["aq"]
                return dequantize(block_in, a.scale, a.zero_point)

            def cbn(name, inp, stride_, padding, relu, out_quant):
                return _conv_bn(
                    bp[name], bs.get(name, {}), inp, stride=stride_, padding=padding, relu=relu,
                    capture=capture, path=f"{prefix}/{name}", out_quant=out_quant, flags=flags,
                    slot=slot(stage, str(bi), name),
                )

            if bottleneck:
                out = cbn("conv1", x, 1, "VALID", True, _chain_aq(bp["conv1"], bp["conv2"]))
                out = cbn("conv2", out, stride, pad3, True, _chain_aq(bp["conv2"], bp["conv3"]))
                out = cbn("conv3", out, 1, "VALID", False, bp["conv3"].get("oq"))
            else:
                # Basic block: torchvision puts the stride on conv1.
                out = cbn("conv1", x, stride, pad3, True, _chain_aq(bp["conv1"], bp["conv2"]))
                out = cbn("conv2", out, 1, pad3, False, bp["conv2"].get("oq"))

            identity = None
            if "downsample" in bp:
                ds = bp["downsample"]
                # A static downsample takes the raw int8 input: its domain is
                # conv1's (static._validate_sibling_domains).
                raw = x.dtype == torch.int8 and isinstance(ds.get("aq"), ActQuant)
                identity = cbn("downsample", x if raw else dequant_in(), stride, "VALID", False,
                               ds.get("oq"))
                if capture is not None:
                    capture[f"{prefix}/{last}:out"] = out
                    capture[f"{prefix}/downsample:out"] = identity
                if identity.dtype == torch.int8:
                    identity = dequantize(identity, ds["oq"].scale, ds["oq"].zero_point)

            nxt = _next_conv1(params, si, bi)
            boundary_aq = _chain_aq(bp[last], nxt) if nxt is not None else None
            if boundary_aq is not None and out.dtype != torch.int8 and not train:
                # The block boundary in one pass (resnet.py:434-452).
                if identity is None and block_in.dtype == torch.int8:
                    x = boundary(out, block_in, bp["conv1"]["aq"], boundary_aq)
                else:
                    x = boundary(out, identity if identity is not None else block_in, None,
                                 boundary_aq)
                continue
            if identity is None:
                identity = dequant_in()
            if out.dtype == torch.int8:
                oq = bp[last]["oq"]
                out = dequantize(out, oq.scale, oq.zero_point)
            x = torch.relu(out + identity)
            if boundary_aq is not None:
                x = quantize_affine(x, boundary_aq.scale, boundary_aq.zero_point)

    x = avgpool_global(x)
    capture_input(capture, "fc", x, ("linear", None, None, None))
    return linear(params["fc"], x, flags=flags), new_state if train else state
