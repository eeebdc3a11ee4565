"""The ResNet block boundary: the port of residual_boundary
(quantnet/ops/pallas_boundary.py:85).

    q = int8(clip(round(relu(out + ident) / out_s) + out_zp, -128, 127))

with ident the int8 identity dequantized in its own domain,
(id - id_zp) * id_s, or the f32 identity as it is. out is the f32 output of
the block's last conv (bias applied, no relu), and q lands in the next
block's input domain: the int8 handoff across the block boundary.

`residual_boundary` launches csrc/residual_boundary.cu on a CUDA tensor and
runs `residual_boundary_plain` on a CPU tensor; there is no other route. The
plain version is the JAX package's default route written in PyTorch ops
(dequantize -> relu(out + identity) -> quantize_affine,
quantnet/models/resnet.py:453-463), and the kernel is bit-exact against it.

The identity's domain comes as an ActQuant (`id_quant`, None for an f32
identity) where the JAX function takes its scale and zero point apart: the
kernel takes its scalars by value, and an ActQuant keeps their host copies.
"""
from __future__ import annotations

from typing import Optional

import torch

from quantnet_torch import _build
from quantnet_torch.core.quantize import dequantize, quantize_affine
from quantnet_torch.core.types import ActQuant


def residual_boundary_plain(
    out: torch.Tensor,
    identity: torch.Tensor,
    id_quant: Optional[ActQuant],
    out_quant: ActQuant,
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops, on any device."""
    ident = identity
    if identity.dtype == torch.int8:
        ident = dequantize(identity, id_quant.scale, id_quant.zero_point)
    return quantize_affine(torch.relu(out + ident), out_quant.scale, out_quant.zero_point)


def _check_operands(out, identity, id_quant) -> None:
    if out.dtype != torch.float32 or identity.dtype not in (torch.int8, torch.float32):
        raise TypeError(
            f"residual_boundary takes f32 out and int8 or f32 identity, got {out.dtype}, "
            f"{identity.dtype}"
        )
    if out.shape != identity.shape:
        raise ValueError(
            f"out and identity differ in shape: {tuple(out.shape)} and {tuple(identity.shape)}"
        )
    if out.device != identity.device:
        raise ValueError(f"operands on different devices: {out.device} and {identity.device}")
    if identity.dtype == torch.int8 and id_quant is None:
        raise ValueError("an int8 identity needs its domain (id_quant)")


def residual_boundary(
    out: torch.Tensor,
    identity: torch.Tensor,
    id_quant: Optional[ActQuant],
    out_quant: ActQuant,
) -> torch.Tensor:
    """relu(out + dequant(identity)) -> int8 in `out_quant`'s domain, in one
    kernel on a CUDA tensor; the plain version on a CPU tensor.
    `residual_boundary.launches` counts kernel launches."""
    _check_operands(out, identity, id_quant)
    if out.device.type == "cpu":
        return residual_boundary_plain(out, identity, id_quant, out_quant)
    if out.device.type != "cuda":
        raise ValueError(f"residual_boundary runs on cuda or cpu tensors, got {out.device}")
    if not (out.is_contiguous() and identity.is_contiguous()):
        raise ValueError("residual_boundary's kernel takes contiguous operands")
    q = torch.empty(out.shape, dtype=torch.int8, device=out.device)
    if q.numel() == 0:
        return q
    int8_id = identity.dtype == torch.int8
    id_s, id_zp = id_quant.host_scalars() if int8_id else (0.0, 0.0)
    out_s, out_zp = out_quant.host_scalars()
    fn = _build.kernel("residual_boundary")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(
            out.data_ptr(), identity.data_ptr(), q.data_ptr(), q.numel(), int(int8_id),
            id_s, id_zp, out_s, out_zp, stream,
        )
    _build.check(err, "residual_boundary")
    residual_boundary.launches += 1
    return q


residual_boundary.launches = 0
