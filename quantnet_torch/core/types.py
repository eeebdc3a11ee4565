"""Quantized-tensor data types (counterpart of quantnet/core/types.py).

Plain dataclasses of tensors: PyTorch runs eagerly, so nothing here needs to be
a pytree. A layer dict holds a `QTensor` under 'w' once quantized, and under
'aq' either the `DynamicActQuant` marker (dynamic INT8) or an `ActQuant` with
frozen parameters (static INT8). `ProbeGate` marks a layer of the
sensitivity sweep (quantnet_torch/quantize/policy.py), `FakeQuant` a layer
that trains through fake quantization (quantnet_torch/quantize/qat.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

_HANDOFF_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# K of a nibble-packed operand is zero-padded to a multiple of this: its
# rows are then a multiple of 16 bytes, the int8 GEMM kernel's TMA stride.
PACK_ALIGN = 32


def pack_nibbles(v_nk: torch.Tensor) -> torch.Tensor:
    """int8[N, K] of 4-bit values (-8..7) -> uint8[N, K'/2], K' = K rounded
    up to PACK_ALIGN: two's-complement nibbles packed along K, the even k in
    the low nibble, the padding zero nibbles. A zero byte unpacks to two
    zeros, as the kernel's zero fill past K needs."""
    n, k = v_nk.shape
    v = torch.nn.functional.pad(v_nk.to(torch.int16), (0, -k % PACK_ALIGN)) & 0x0F
    return (v[:, 0::2] | (v[:, 1::2] << 4)).to(torch.uint8).contiguous()


def unpack_nibbles(p: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """pack_nibbles' inverse: uint8[N, W] -> int8[N, k] (k <= 2W, default 2W),
    each nibble sign-extended."""
    b = p.to(torch.int16)
    lo, hi = b & 0x0F, b >> 4
    v = (torch.stack([lo, hi], dim=-1).reshape(p.shape[0], -1) ^ 8) - 8
    return v[:, : (2 * p.shape[1] if k is None else k)].to(torch.int8)


@dataclass
class QTensor:
    """An int8-quantized tensor with its dequantization parameters.

    values: int8 payload, same shape as the original tensor.
    scale:  f32 scale; () per-tensor, or shaped to broadcast against `values`
            per-channel (e.g. (1, N) for a (K, N) weight, (1, 1, 1, O) for an
            HWIO conv weight).
    zero_point: optional int32 zero point; None means symmetric.
    axis:   channel axis of a per-channel scale, or None for per-tensor.
    bits:   quantized bit width (values lie in [-2**(bits-1)+1, 2**(bits-1)-1]);
            a 4-bit payload stays int8 at run time unless the s4 runtime
            packs it (`packed_shape`), and is packed two to a byte on disk
            (quantnet_torch/train/checkpoint.py, with a +8 offset there).
    group_size: rows of the reduction axis 0 that share a scale, or None.
            A grouped (K, N) weight has a (K // g, 1, N) scale.
    packed_shape: None, or the s4 runtime payload
            (quantize/common.py::s4_runtime_tree): `values` is then the
            weight as the int8 GEMM kernel reads it, uint8[N, K'/2]
            (pack_nibbles of `nk()`), and this the logical shape. No int8
            copy is kept; `int8_values()` widens one when an op asks.

    Dequantization contract: ``(values - zero_point) * scale``, a grouped
    scale broadcast over its group's rows.
    """

    values: torch.Tensor
    scale: torch.Tensor
    zero_point: Optional[torch.Tensor] = None
    axis: Optional[int] = None
    bits: int = 8
    group_size: Optional[int] = None
    _nk: Optional[torch.Tensor] = field(default=None, repr=False, compare=False)
    packed_shape: Optional[Tuple[int, ...]] = None

    @property
    def shape(self):
        return self.values.shape if self.packed_shape is None else torch.Size(self.packed_shape)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def is_packed(self) -> bool:
        return self.packed_shape is not None

    def int8_values(self) -> torch.Tensor:
        """The payload as int8 of the logical shape: `values` itself, or a
        transient widening of the packed one (contiguous, as `values` is:
        the layout can change which summation order a CPU conv takes)."""
        if self.packed_shape is None:
            return self.values
        k = math.prod(self.packed_shape[:-1])
        return unpack_nibbles(self.values, k).t().contiguous().reshape(self.packed_shape)

    def packed(self) -> "QTensor":
        """This 4-bit weight with its payload nibble-packed (packed_shape)."""
        if self.packed_shape is not None:
            return self
        if self.bits != 4:
            raise ValueError(f"only a 4-bit payload packs, not {self.bits}-bit")
        return QTensor(values=pack_nibbles(self.nk()), scale=self.scale,
                       zero_point=self.zero_point, axis=self.axis, bits=self.bits,
                       group_size=self.group_size, packed_shape=tuple(self.values.shape))

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        v = self.int8_values().to(dtype)
        if self.zero_point is not None:
            v = v - self.zero_point.to(dtype)
        if self.group_size is not None:
            shape = v.shape
            v = v.reshape(-1, self.group_size, *shape[1:])
            return (v * self.scale.to(dtype)).reshape(shape)
        return v * self.scale.to(dtype)

    @property
    def nbytes(self) -> int:
        """Bytes on disk: the payload packed to `bits` (two 4-bit values to
        a byte), the scale and the zero point."""
        n = -(-math.prod(self.shape) * self.bits // 8)
        n += self.scale.numel() * self.scale.element_size()
        if self.zero_point is not None:
            n += self.zero_point.numel() * self.zero_point.element_size()
        return n

    def nk(self) -> torch.Tensor:
        """The weight as the GEMM kernels take it: int8[N, K], K contiguous
        (the packed uint8[N, K'/2] operand itself when packed).

        `values` is (K, N) for a dense layer and HWIO for a conv, whose im2col
        reduction K is kh*kw*C in that order. Weights are constant, so the
        transposed copy is made once and kept.
        """
        if self.packed_shape is not None:
            return self.values
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


@dataclass(frozen=True)
class ProbeGate:
    """A layer's selector in the sensitivity sweep (quantnet/core/types.py:229-256),
    kept under the layer's 'probe' key by policy.measure_sensitivity.

    gate:        1.0 (or True) runs the layer's quantized lane, 0.0 its plain
                 lane. Host data: PyTorch runs eagerly, so the op runs only the
                 lane the gate picks, the same value the JAX package selects
                 with `jnp.where(gate > 0.5, y_q, y_fp)` from both lanes.
    per_channel: the weight quantization's axis choice for the quantized lane.
    bits:        the quantized lane's weight width (8 or 4).
    group_size:  group-wise scales along K (dense layers), or None.
    act_quant:   True quantizes the activations per batch too (the dynamic
                 INT8 path: the optimized scheme's damage model); False is
                 weight-only (the int4 guard's damage model).
    """

    gate: float
    per_channel: bool = True
    bits: int = 8
    group_size: Optional[int] = None
    act_quant: bool = True


@dataclass(frozen=True)
class FakeQuant:
    """A QAT training island (quantnet/core/types.py:158-225), kept under a
    float layer's 'fq' key by qat.prepare. The layer then computes with
    fake-quantized (quantize -> dequantize, straight-through gradients)
    weights and activations, in f32: the deployed static INT8 layer, made
    differentiable.

    scale / zero_point: the input's frozen calibration range, host numbers
        (no tensors, so the optimizer never sees them).
    per_channel:        the weight quantization's axis choice, which the
                        bake repeats.
    weight_bits / weight_group_size: the weight grid (8 or 4 bits; groups
                        along K for dense layers), as quantize_weight takes it.
    act_quant:          False trains a weight-only island (f32 activations;
                        scale and zero_point unused).
    """

    scale: float
    zero_point: int
    per_channel: bool = True
    weight_bits: int = 8
    weight_group_size: Optional[int] = None
    act_quant: bool = True

    def __post_init__(self):
        object.__setattr__(self, "scale", float(self.scale))
        object.__setattr__(self, "zero_point", int(self.zero_point))
        if self.weight_group_size is not None:
            object.__setattr__(self, "weight_group_size", int(self.weight_group_size))


def tree_nbytes(tree) -> int:
    """Model size: the bytes of every tensor of a params tree, a QTensor by
    its packed `nbytes` (quantnet/core/types.py:263-279). The GEMM constants
    under 'gemm' are a copy the kernels read, made where the tree is built,
    not part of the model, and are left out."""
    if isinstance(tree, QTensor):
        return tree.nbytes
    if isinstance(tree, ActQuant):
        return tree_nbytes(tree.scale) + tree_nbytes(tree.zero_point)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for k, v in tree.items() if k != "gemm")
    return 0
