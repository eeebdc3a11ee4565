"""Calibration observers for static PTQ (counterpart of
quantnet/core/observers.py:27-100).

An observer holds running statistics of one layer input as eager tensors,
updated in place by `update(x)`, and turns them into frozen affine
(scale, zero_point) with `qparams()`. The JAX package extracts those under
jit, so `qparams` takes the `/ 255` of `affine_qparams` as XLA computes it
there (a multiply by the f32 reciprocal; quantnet_torch/core/quantize.py).

The histogram and MSE observers come with a later slice; `make_observer`
raises for them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from quantnet_torch.core.quantize import affine_qparams


class MinMaxObserver:
    """Running global min / max."""

    def __init__(self):
        self.min = torch.tensor(float("inf"))
        self.max = torch.tensor(float("-inf"))

    def update(self, x: torch.Tensor) -> "MinMaxObserver":
        self.min = torch.minimum(self.min.to(x.device), torch.amin(x).float())
        self.max = torch.maximum(self.max.to(x.device), torch.amax(x).float())
        return self

    def qparams(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return affine_qparams(self.min, self.max)


class MovingAvgMinMaxObserver:
    """EMA of the per-batch min / max; the first batch sets them."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.min = torch.tensor(0.0)
        self.max = torch.tensor(0.0)
        self.initialized = False

    def update(self, x: torch.Tensor) -> "MovingAvgMinMaxObserver":
        bmin, bmax = torch.amin(x).float(), torch.amax(x).float()
        if self.initialized:
            m = self.momentum
            bmin = m * self.min.to(x.device) + (1 - m) * bmin
            bmax = m * self.max.to(x.device) + (1 - m) * bmax
        self.min, self.max, self.initialized = bmin, bmax, True
        return self

    def qparams(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return affine_qparams(self.min, self.max)


OBSERVERS = {"minmax": MinMaxObserver, "moving_average": MovingAvgMinMaxObserver}
LATER = ("histogram", "mse")


def make_observer(kind: str, **kwargs):
    if kind in LATER:
        raise NotImplementedError(f"the {kind!r} observer comes with a later slice")
    try:
        return OBSERVERS[kind](**kwargs)
    except KeyError:
        raise ValueError(f"unknown observer {kind!r}; have {sorted(OBSERVERS)}") from None
