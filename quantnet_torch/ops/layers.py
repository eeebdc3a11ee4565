"""Stateless layer helpers (counterpart of quantnet/ops/layers.py:19-97).

Inference only: batchnorm with running statistics, BN folding, NHWC max
pooling, global average pooling and dropout (the identity at inference). Training-mode batchnorm and
dropout come with the trainer in a later slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

BN_EPS = 1e-5


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


def maxpool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """NHWC max pool, 2x2 window, stride 2, VALID (any dtype; exact)."""
    if window != stride:
        raise NotImplementedError("only non-overlapping windows (window == stride)")
    n, h, w, c = x.shape
    ho, wo = h // window, w // window
    x = x[:, : ho * window, : wo * window, :]
    return x.reshape(n, ho, window, wo, window, c).amax(dim=(2, 4))


def avgpool_global(x: torch.Tensor) -> torch.Tensor:
    """Global average pool NHWC -> NC (layers.py:87-89)."""
    return torch.mean(x, dim=(1, 2))


def dropout(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inference dropout: the identity."""
    return x
