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

Inside `sharded_batch(axis)` a rank's rows are its share of a global batch
(quantnet_torch/parallel/steps.py): train-mode batchnorm takes the global
batch's statistics, summed across ranks through `axis.sum` (which autograd
sees, so the gradient reaches every rank's rows), as the JAX step's
`jnp.mean` over a batch-sharded axis is global; dropout draws the global
batch's mask and keeps this rank's rows, so the ranks together draw what
one process draws for the whole batch. Between a column-parallel layer and
the row-parallel one after it (parallel/tensor.py: fc1's output columns
split over the model axis), a 2-D activation of the shard's width is this
rank's columns: dropout then draws the global [M, N] mask and keeps its
rows and its columns.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from quantnet_torch.core.quantize import _mul_reciprocal

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # new = (1 - m) * running + m * batch

# The batch axis a train-mode forward's rows are a shard of: an object with
# `rank`, `size` (ranks, each holding an equal share of the global batch)
# and `sum(t)` (the sum of every rank's t, differentiable); None in one
# process.
_BATCH_AXIS: contextvars.ContextVar = contextvars.ContextVar("batch_axis", default=None)


# The features a column-parallel layer left split: (index, size, width) of
# this rank's columns on the model axis, set by that layer and cleared by the
# row-parallel layer that reduces them (ops/linear.py); None elsewhere.
_COLUMNS: contextvars.ContextVar = contextvars.ContextVar("column_shard", default=None)


def set_column_shard(columns) -> None:
    """Mark the activations of `columns` = (index, size, width) as column
    shards until the next call (None clears it)."""
    _COLUMNS.set(columns)


@contextlib.contextmanager
def sharded_batch(axis):
    """Run train-mode BN and dropout as shards of a global batch over `axis`."""
    token = _BATCH_AXIS.set(axis)
    try:
        yield
    finally:
        _BATCH_AXIS.reset(token)


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
    the graph, toward the batch mean and the unbiased variance. Inside
    `sharded_batch` the batch is the global one."""
    red = tuple(range(x.ndim - 1))
    n = x.numel() // x.shape[-1]
    axis = _BATCH_AXIS.get()
    if axis is None:
        mean = x.mean(dim=red)
        centered = x - mean
        var = (centered * centered).mean(dim=red)
    else:
        n *= axis.size
        mean = axis.sum(x.sum(dim=red)) / n
        centered = x - mean
        var = axis.sum((centered * centered).sum(dim=red)) / n
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
    of keep, on the generator's device; inside `sharded_batch` drawn for the
    global batch, this rank's rows kept); with neither, the identity."""
    if rate == 0.0 or (generator is None and mask is None):
        return x
    keep = 1.0 - rate
    if mask is None:
        axis, cols = _BATCH_AXIS.get(), _COLUMNS.get()
        if cols is not None and not (x.ndim == 2 and x.shape[1] == cols[2]):
            cols = None
        if axis is None and cols is None:
            mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
        else:
            m, shape = x.shape[0], list(x.shape)
            ranks = 1 if axis is None else axis.size
            shape[0] *= ranks
            if cols is not None:
                shape[1] *= cols[1]
            draw = torch.rand(shape, generator=generator, device=generator.device)
            if axis is not None:
                draw = draw[axis.rank * m:(axis.rank + 1) * m]
            if cols is not None:
                draw = draw[:, cols[0] * cols[2]:(cols[0] + 1) * cols[2]]
            mask = draw < keep
    return torch.where(mask.to(x.device), _mul_reciprocal(x, keep), 0.0)
