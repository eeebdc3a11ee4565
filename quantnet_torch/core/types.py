"""Quantized-tensor data types (counterpart of quantnet/core/types.py).

Plain dataclasses of tensors: PyTorch runs eagerly, so nothing here needs to be
a pytree. A layer dict holds a `QTensor` under 'w' once quantized, and under
'aq' either the `DynamicActQuant` marker (dynamic INT8) or an `ActQuant` with
frozen parameters (static INT8).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

_HANDOFF_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class QTensor:
    """An int8-quantized tensor with its dequantization parameters.

    values: int8 payload, same shape as the original tensor.
    scale:  f32 scale; () per-tensor, or shaped to broadcast against `values`
            per-channel (e.g. (1, N) for a (K, N) weight, (1, 1, 1, O) for an
            HWIO conv weight).
    zero_point: optional int32 zero point; None means symmetric.
    axis:   channel axis of a per-channel scale, or None for per-tensor.
    bits:   quantized bit width (values lie in [-2**(bits-1)+1, 2**(bits-1)-1]).

    Dequantization contract: ``(values - zero_point) * scale``.
    """

    values: torch.Tensor
    scale: torch.Tensor
    zero_point: Optional[torch.Tensor] = None
    axis: Optional[int] = None
    bits: int = 8
    _nk: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        v = self.values.to(dtype)
        if self.zero_point is not None:
            v = v - self.zero_point.to(dtype)
        return v * self.scale.to(dtype)

    def nk(self) -> torch.Tensor:
        """The weight as the GEMM kernels take it: int8[N, K], K contiguous.

        `values` is (K, N) for a dense layer and HWIO for a conv, whose im2col
        reduction K is kh*kw*C in that order. Weights are constant, so the
        transposed copy is made once and kept.
        """
        if self._nk is None:
            k_n = self.values.reshape(-1, self.values.shape[-1])
            self._nk = k_n.t().contiguous()
        return self._nk


@dataclass(frozen=True)
class DynamicActQuant:
    """Marker: quantize this layer's input per batch (dynamic PTQ).

    handoff: optional narrow inter-layer dtype name ("bfloat16"). The layer
    writes its output in that dtype; the consumer re-quantizes it per batch
    anyway, so the rounding stays below the quantization step.
    """

    handoff: Optional[str] = None

    @property
    def handoff_dtype(self) -> Optional[torch.dtype]:
        return None if self.handoff is None else _HANDOFF_DTYPES[self.handoff]


@dataclass
class ActQuant:
    """Frozen (static-PTQ) quantization parameters of one layer input
    (quantnet/core/types.py:102-117): f32 scale () and int32 zero_point ().

    Under a layer's 'aq' it switches the layer ops to the static-INT8 path;
    passed as `out_quant` it makes a producer requantize its output into this
    domain (the int8 tensor handoff).
    """

    scale: torch.Tensor
    zero_point: torch.Tensor
    _host: Optional[tuple] = field(default=None, repr=False, compare=False)

    def host_scalars(self) -> tuple:
        """(scale, zero_point) as Python floats, for a kernel that takes them
        by value. The parameters are frozen, so they are read off the device
        once and kept."""
        if self._host is None:
            self._host = (float(self.scale), float(self.zero_point))
        return self._host
