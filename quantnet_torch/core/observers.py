"""Calibration observers for static PTQ (counterpart of
quantnet/core/observers.py:27-100 and 137-291).

An observer holds running statistics of one layer input as eager tensors,
updated in place by `update(x)`, and turns them into frozen affine
(scale, zero_point) with `qparams()`. The JAX package extracts those under
jit, so `qparams` takes the `/ 255` of `affine_qparams` as XLA computes it
there (a multiply by the f32 reciprocal; quantnet_torch/core/quantize.py).

The histogram and MSE observers share one fixed-range histogram: its range
freezes on the first update with 3x headroom, and a value goes to bin
`int32((x - lo) / (hi - lo) * bins)`, clipped. The JAX package counts with a
scatter-add of 1.0 into f32, which stops at 2^24 in a bin of one batch (a
post-relu ResNet-50 input at bs128 puts about 5e7 zeros in one bin); the
port counts exactly (`torch.bincount`) and adds the batch's counts to the
running f32 counts, so both agree bit for bit wherever the JAX counts are
exact (ROADMAP Queue 3).

`merge_all(states)` folds the finished observers of several processes, in
the order given, into one (quantnet/core/observers.py:46-54, 87-104,
107-135, 197-205, 276-283), bit for bit as the JAX package's eager
`merge_all`: min of the mins and max of the maxes; the mean of the moving
averages over the observers that saw data; the histograms re-binned onto
their common range, each bucket's mass at its centre. That re-bin adds in
f32, and several source buckets can land in one target bucket, so the
port adds in state order, then bucket order, as XLA's CPU scatter does
(numpy's unbuffered `add.at` on the host). Merging runs on the host; the
merged observer lies on the first state's device.
"""
from __future__ import annotations

import copy
from typing import Sequence, Tuple

import numpy as np
import torch

from quantnet_torch.core.quantize import INT8_MAX, INT8_MIN, _mul_reciprocal, affine_qparams


class _Observer:
    @property
    def device(self) -> torch.device:
        """Where the observer's statistics lie (its first tensor's device)."""
        return next(v for v in vars(self).values() if isinstance(v, torch.Tensor)).device

    def to(self, device) -> "_Observer":
        """A copy with its tensors on `device`."""
        out = copy.copy(self)
        for k, v in vars(out).items():
            if isinstance(v, torch.Tensor):
                setattr(out, k, v.to(device))
        return out


def _host_states(states: Sequence[_Observer]):
    """(the states on the host, the first state's device)."""
    return [s.to("cpu") for s in states], states[0].device


def _ordered_sum(values: torch.Tensor) -> torch.Tensor:
    acc = values[0]
    for v in values[1:]:
        acc = acc + v
    return acc


class MinMaxObserver(_Observer):
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

    @classmethod
    def merge_all(cls, states: Sequence["MinMaxObserver"]) -> "MinMaxObserver":
        """The min of the mins, the max of the maxes: what one process
        observing every process's data holds."""
        host, device = _host_states(states)
        out = cls()
        out.min = torch.min(torch.stack([s.min.float() for s in host])).to(device)
        out.max = torch.max(torch.stack([s.max.float() for s in host])).to(device)
        return out


class MovingAvgMinMaxObserver(_Observer):
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

    @classmethod
    def merge_all(cls, states: Sequence["MovingAvgMinMaxObserver"]) -> "MovingAvgMinMaxObserver":
        """The mean of the moving averages over the observers that saw data
        (the same list folded alike on every process gives the same bits)."""
        host, device = _host_states(states)
        init = torch.tensor([float(s.initialized) for s in host])
        n = torch.clamp_min(_ordered_sum(init), 1.0)
        out = cls(momentum=states[0].momentum)
        out.min = (_ordered_sum(torch.stack([s.min.float() for s in host]) * init) / n).to(device)
        out.max = (_ordered_sum(torch.stack([s.max.float() for s in host]) * init) / n).to(device)
        out.initialized = any(s.initialized for s in host)
        return out


class _FixedRangeHistogram(_Observer):
    """f32 counts over `bins` equal buckets of [lo, hi], frozen at the first
    update (quantnet/core/observers.py:159-177)."""

    def __init__(self, bins: int = 2048):
        self.bins = bins
        self.counts = torch.zeros(bins)
        self.lo = torch.tensor(0.0)
        self.hi = torch.tensor(1.0)
        self.initialized = False

    def update(self, x: torch.Tensor):
        x = x.float().reshape(-1)
        if not self.initialized:
            bmin, bmax = torch.amin(x), torch.amax(x)
            lo = torch.minimum(bmin * 3.0, bmin)
            hi = torch.maximum(bmax * 3.0, bmax)
            self.lo, self.hi = lo, torch.where(hi > lo, hi, lo + 1.0)
            self.counts = self.counts.to(x.device)
            self.initialized = True
        # Clamping before the cast truncates as int32-then-clip does, and
        # keeps values beyond int32's range defined.
        t = torch.clamp((x - self.lo) / (self.hi - self.lo) * float(self.bins), 0.0, self.bins - 1)
        idx = t.to(torch.int64)
        self.counts = self.counts + torch.bincount(idx, minlength=self.bins).float()
        return self

    def _cdf(self) -> torch.Tensor:
        total = torch.clamp_min(self.counts.sum(), 1.0)
        return torch.cumsum(self.counts, 0) / total

    def _grid(self, offset: float, n: int) -> torch.Tensor:
        """lo + (hi - lo) * ((arange(n) + offset) / bins): the bucket edges
        (offset 0, n = bins + 1) or centers (offset 0.5, n = bins)."""
        frac = (torch.arange(n, dtype=torch.float32, device=self.counts.device) + offset) / float(self.bins)
        return self.lo + (self.hi - self.lo) * frac

    @classmethod
    def _merged(cls, states: Sequence["_FixedRangeHistogram"], **kwargs) -> "_FixedRangeHistogram":
        """The histograms re-binned onto their common range [min lo, max hi]
        of the observers that saw data, each bucket's mass at its centre
        (quantnet/core/observers.py:107-135)."""
        host, device = _host_states(states)
        bins = states[0].bins
        init = [s.initialized for s in host]
        inf = torch.tensor(float("inf"))
        lo = torch.min(torch.stack([s.lo.float() if i else inf for s, i in zip(host, init)]))
        hi = torch.max(torch.stack([s.hi.float() if i else -inf for s, i in zip(host, init)]))
        lo = lo if any(init) else torch.tensor(0.0)
        hi = hi if any(init) and hi > lo else lo + 1.0
        counts = np.zeros(bins, np.float32)
        for s in host:
            centers = s._grid(0.5, bins)
            t = torch.clamp((centers - lo) / (hi - lo) * float(bins), 0.0, bins - 1)
            np.add.at(counts, t.to(torch.int64).numpy(), s.counts.float().numpy())
        out = cls(bins=bins, **kwargs)
        out.counts = torch.from_numpy(counts).to(device)
        out.lo, out.hi, out.initialized = lo.to(device), hi.to(device), any(init)
        return out


def _searchsorted(cdf: torch.Tensor, value: float) -> torch.Tensor:
    """jnp.searchsorted(cdf, value) with side='left', value taken as f32."""
    return torch.searchsorted(cdf, torch.tensor([value], dtype=torch.float32, device=cdf.device))[0]


class HistogramObserver(_FixedRangeHistogram):
    """Percentile clipping: the clip range covers `percentile` of the mass
    (quantnet/core/observers.py:137-205)."""

    def __init__(self, bins: int = 2048, percentile: float = 0.9999):
        super().__init__(bins)
        self.percentile = percentile

    def qparams(self) -> Tuple[torch.Tensor, torch.Tensor]:
        cdf = self._cdf()
        edges = self._grid(0.0, self.bins + 1)
        tail = (1.0 - self.percentile) / 2.0
        lo_idx = torch.clamp(_searchsorted(cdf, tail), 0, self.bins)
        hi_idx = torch.clamp(_searchsorted(cdf, 1.0 - tail) + 1, 0, self.bins)
        return affine_qparams(edges[lo_idx], edges[hi_idx])

    @classmethod
    def merge_all(cls, states: Sequence["HistogramObserver"]) -> "HistogramObserver":
        return cls._merged(states, percentile=states[0].percentile)


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """jnp.linspace(start, stop, num) in f32 as jitted XLA computes it:
    start * (1 - step) + stop * step with step = iota * f32(1 / (num - 1))
    (the division by a constant turned into a multiply), the last point
    `stop` itself."""
    div = num - 1
    step = _mul_reciprocal(torch.arange(div, dtype=torch.float32), float(div))
    start_t = torch.tensor(start, dtype=torch.float32)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t.reshape(1)])


class MSEObserver(_FixedRangeHistogram):
    """The clip range of least expected int8 quantization error over the
    observed histogram, from `num_candidates` ranges shrunk in fraction
    (quantnet/core/observers.py:207-291)."""

    def __init__(self, bins: int = 2048, num_candidates: int = 64):
        super().__init__(bins)
        self.num_candidates = num_candidates

    def qparams(self) -> Tuple[torch.Tensor, torch.Tensor]:
        centers = self._grid(0.5, self.bins)
        cdf = self._cdf()
        # An index past the end reads the last center, as XLA's gather clamps.
        obs_lo = centers[torch.clamp(_searchsorted(cdf, 1e-9), 0, self.bins - 1)]
        obs_hi = centers[torch.clamp(_searchsorted(cdf, 1.0 - 1e-9), 0, self.bins - 1)]
        fracs = _linspace_f32(1.0, 1.0 / self.num_candidates, self.num_candidates).to(centers.device)
        scale, zp = affine_qparams(
            torch.clamp_max(obs_lo * fracs, 0.0), torch.clamp_min(obs_hi * fracs, 0.0)
        )
        scale, zp = scale[:, None], zp[:, None].float()
        q = torch.clamp(torch.round(centers / scale) + zp, INT8_MIN, INT8_MAX)
        deq = (q - zp) * scale
        mses = torch.sum(self.counts * (centers - deq) ** 2, dim=1)
        best = fracs[torch.argmin(mses)]
        return affine_qparams(torch.clamp_max(obs_lo * best, 0.0), torch.clamp_min(obs_hi * best, 0.0))

    @classmethod
    def merge_all(cls, states: Sequence["MSEObserver"]) -> "MSEObserver":
        return cls._merged(states, num_candidates=states[0].num_candidates)


OBSERVERS = {
    "minmax": MinMaxObserver,
    "moving_average": MovingAvgMinMaxObserver,
    "histogram": HistogramObserver,
    "mse": MSEObserver,
}


def make_observer(kind: str, **kwargs):
    try:
        return OBSERVERS[kind](**kwargs)
    except KeyError:
        raise ValueError(f"unknown observer {kind!r}; have {sorted(OBSERVERS)}") from None
