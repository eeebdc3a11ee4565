"""Import the reference project's PyTorch checkpoints into the port's trees
(counterpart of quantnet/models/torch_import.py:161-345).

Reference users hold `.pth` checkpoints in two formats: the full dict
{'model_state_dict', ..., 'best_accuracy'} and the raw state dict, plus
torchvision ResNet weights for the ImageNet track. They are read with
`torch.load(..., weights_only=True)`, which unpickles tensors, containers and
plain numbers and refuses any other object. The converters lay the weights
out as the JAX package does, which is what the port's models take:

  conv OIHW -> HWIO; linear (out, in) -> (in, out)
  batchnorm weight / bias -> params gamma / beta, running_mean / var -> state
  the SimpleConvNet's fc1 input dim: torch flattens NCHW, so it is ordered
  (C, H, W); the port flattens NHWC, (H, W, C), and the weight is permuted
  to match.

An imported ResNet runs with `resnet.apply(..., torch_pad=True)`: torch pads
its stride-2 convs symmetrically. MobileNetV2 comes with ROADMAP Queue 1
item 3.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from quantnet_torch.core.config import resolve_device
from quantnet_torch.models.convnet import CONV_DEFS


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _split(blob) -> Tuple[Dict[str, torch.Tensor], Optional[float]]:
    """(state dict, best_accuracy or None) of either reference format."""
    if isinstance(blob, dict) and "model_state_dict" in blob:
        best = blob.get("best_accuracy")
        return blob["model_state_dict"], (float(best) if best is not None else None)
    return blob, None


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A `.pth` in either reference format -> its raw state dict."""
    return _split(_load(path))[0]


class _Converter:
    """Reads a state dict onto `device` in the port's layouts."""

    def __init__(self, sd: Dict[str, torch.Tensor], device):
        self.sd = sd
        self.device = device

    def f32(self, key: str) -> torch.Tensor:
        return self.sd[key].detach().to(torch.float32).contiguous().to(self.device)

    def conv_w(self, key: str) -> torch.Tensor:
        return self.sd[key].detach().to(torch.float32).permute(2, 3, 1, 0).contiguous().to(self.device)

    def linear_w(self, key: str) -> torch.Tensor:
        return self.sd[key].detach().to(torch.float32).t().contiguous().to(self.device)

    def bn(self, prefix: str) -> Tuple[dict, dict]:
        params = {"gamma": self.f32(f"{prefix}.weight"), "beta": self.f32(f"{prefix}.bias")}
        state = {"mean": self.f32(f"{prefix}.running_mean"), "var": self.f32(f"{prefix}.running_var")}
        return params, state

    def conv_bn(self, conv_key: str, bn_key: str, slot_state: dict) -> dict:
        bn_p, bn_s = self.bn(bn_key)
        slot_state.update(bn_s)
        layer = {"w": self.conv_w(f"{conv_key}.weight"), "bn": bn_p}
        if f"{conv_key}.bias" in self.sd:
            layer["b"] = self.f32(f"{conv_key}.bias")
        return layer


def convnet_from_torch(sd: Dict[str, torch.Tensor], *, device="cuda") -> Tuple[dict, dict]:
    """The reference SimpleConvNet's state dict -> (params, state): conv1-6
    with bn1-6, fc1 with bn7, fc2."""
    c = _Converter(sd, resolve_device(device))
    params: dict = {}
    state: dict = {}
    for i, (name, _cin, _cout) in enumerate(CONV_DEFS, start=1):
        bn_p, state[name] = c.bn(f"bn{i}")
        params[name] = {"w": c.conv_w(f"conv{i}.weight"), "b": c.f32(f"conv{i}.bias"), "bn": bn_p}
    w = sd["fc1.weight"].detach().to(torch.float32)  # (512, C * H * W)
    out_dim, ch = w.shape[0], CONV_DEFS[-1][2]
    hw = math.isqrt(w.shape[1] // ch)
    w = w.reshape(out_dim, ch, hw, hw).permute(2, 3, 1, 0).reshape(-1, out_dim)
    bn_p, state["fc1"] = c.bn("bn7")
    params["fc1"] = {"w": w.contiguous().to(c.device), "b": c.f32("fc1.bias"), "bn": bn_p}
    params["fc2"] = {"w": c.linear_w("fc2.weight"), "b": c.f32("fc2.bias")}
    return params, state


def resnet_from_torch(sd: Dict[str, torch.Tensor], *, device="cuda") -> Tuple[dict, dict]:
    """A torchvision ResNet state dict of any depth -> (params, state). The
    structure (blocks per stage, basic or bottleneck) is read off the keys."""
    c = _Converter(sd, resolve_device(device))
    params: dict = {}
    state: dict = {"conv1": {}}
    params["conv1"] = c.conv_bn("conv1", "bn1", state["conv1"])
    n_convs = 3 if "layer1.0.conv3.weight" in sd else 2
    for si in range(4):
        stage = f"layer{si + 1}"
        params[stage], state[stage] = {}, {}
        bi = 0
        while f"{stage}.{bi}.conv1.weight" in sd:
            t = f"{stage}.{bi}"
            bp: dict = {}
            bs: dict = {}
            for ci in range(1, n_convs + 1):
                bs[f"conv{ci}"] = {}
                bp[f"conv{ci}"] = c.conv_bn(f"{t}.conv{ci}", f"{t}.bn{ci}", bs[f"conv{ci}"])
            if f"{t}.downsample.0.weight" in sd:
                bs["downsample"] = {}
                bp["downsample"] = c.conv_bn(f"{t}.downsample.0", f"{t}.downsample.1", bs["downsample"])
            params[stage][str(bi)], state[stage][str(bi)] = bp, bs
            bi += 1
    params["fc"] = {"w": c.linear_w("fc.weight"), "b": c.f32("fc.bias")}
    return params, state


# The reference's ImageNet track is ResNet-50 (quantnet/models/torch_import.py:320).
resnet50_from_torch = resnet_from_torch


def import_checkpoint(
    path: str, model: str = "simple_convnet", *, device="cuda"
) -> Tuple[dict, dict, Optional[float]]:
    """Load and convert a reference `.pth`. Returns (params, state,
    best_accuracy), the last None for a raw state dict."""
    if model.startswith("mobilenetv2"):
        raise NotImplementedError(
            "importing MobileNetV2 comes with its port (ROADMAP Queue 1 item 3)"
        )
    if model != "simple_convnet" and not model.startswith("resnet"):
        raise ValueError(f"unknown model {model!r}")
    device = resolve_device(device)
    sd, best = _split(_load(path))
    if model == "simple_convnet":
        params, state = convnet_from_torch(sd, device=device)
    else:
        params, state = resnet_from_torch(sd, device=device)
    return params, state, best
