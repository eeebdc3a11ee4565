"""Stateless layer helpers (counterpart of quantnet/ops/layers.py:19-97):
batchnorm (inference, train, fold), NHWC max pooling, global average
pooling and dropout.

Train-mode batchnorm normalizes with the batch's biased variance and moves
the running statistics by momentum 0.1 toward the batch mean and unbiased
variance. Dropout is the JAX package's `where(mask, x / keep, 0)`, its mask
drawn from an explicit `torch.Generator` or given by the caller; without
either it is the identity, as the JAX package's is without an rng. Max
pooling is exact in any dtype; where a gradient is asked for it goes to the
first maximum of a window, as JAX's reduce_window max sends it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from quantnet_torch.core.quantize import _mul_reciprocal

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # new = (1 - m) * running + m * batch


def batchnorm_init(dim: int, device=None) -> Tuple[dict, dict]:
    params = {
        "gamma": torch.ones(dim, device=device),
        "beta": torch.zeros(dim, device=device),
    }
    state = {
        "mean": torch.zeros(dim, device=device),
        "var": torch.ones(dim, device=device),
    }
    return params, state


def batchnorm_apply(params: dict, state: dict, x: torch.Tensor) -> torch.Tensor:
    """Inference-mode BN over the last axis (NHWC and NC alike)."""
    inv = torch.rsqrt(state["var"] + BN_EPS)
    return (x - state["mean"]) * inv * params["gamma"] + params["beta"]


def batchnorm_train(params: dict, state: dict, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Train-mode BN over the last axis (quantnet/ops/layers.py:26-48):
    normalizes with the batch's mean and biased variance, which the gradient
    goes through. Returns (y, new running statistics); these move, outside
    the graph, toward the batch mean and the unbiased variance."""
    red = tuple(range(x.ndim - 1))
    mean = x.mean(dim=red)
    centered = x - mean
    var = (centered * centered).mean(dim=red)
    n = x.numel() // x.shape[-1]
    with torch.no_grad():
        # m * (var * n / (n - 1)) as XLA folds it under jit: var times the
        # f32 product of the two constants.
        unbiased_m = float(np.float32(BN_MOMENTUM) * np.float32(n / max(n - 1, 1)))
        new_state = {
            "mean": (1 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean,
            "var": (1 - BN_MOMENTUM) * state["var"] + var * unbiased_m,
        }
    y = centered * torch.rsqrt(var + BN_EPS) * params["gamma"] + params["beta"]
    return y, new_state


def fold_batchnorm_into_conv(
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    bn_params: dict,
    bn_state: dict,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BN into the preceding conv (HWIO) or dense (K, N)
    weights; the output channel is the last axis of both.

    w' = w * gamma * rsqrt(var + eps), b' = (b - mean) * factor + beta.
    """
    factor = bn_params["gamma"] * torch.rsqrt(bn_state["var"] + BN_EPS)
    w_f = w * factor
    b0 = b if b is not None else torch.zeros_like(bn_state["mean"])
    b_f = (b0 - bn_state["mean"]) * factor + bn_params["beta"]
    return w_f, b_f


def wants_grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def maxpool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """NHWC max pool, 2x2 window, stride 2, VALID (any dtype; exact). Where
    a gradient is asked for, F.max_pool2d's, which goes to a window's first
    maximum."""
    if window != stride:
        raise NotImplementedError("only non-overlapping windows (window == stride)")
    if wants_grad(x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)
    n, h, w, c = x.shape
    ho, wo = h // window, w // window
    x = x[:, : ho * window, : wo * window, :]
    return x.reshape(n, ho, window, wo, window, c).amax(dim=(2, 4))


def avgpool_global(x: torch.Tensor) -> torch.Tensor:
    """Global average pool NHWC -> NC (layers.py:87-89)."""
    return torch.mean(x, dim=(1, 2))


def dropout(
    x: torch.Tensor,
    rate: float,
    generator: Optional[torch.Generator] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """where(mask, x / keep, 0) with keep = 1 - rate (quantnet/ops/layers.py:
    92-97); x / keep as the jitted JAX step computes it, a multiply by
    f32(1 / keep). The mask is `mask`, or drawn from `generator` (bernoulli
    of keep, on the generator's device); with neither, the identity."""
    if rate == 0.0 or (generator is None and mask is None):
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), _mul_reciprocal(x, keep), 0.0)
