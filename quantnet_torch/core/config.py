"""Backend selection and device checks (counterpart of quantnet/core/config.py).

The JAX package picks a backend from a global flag object. Here the tensor's
device picks it: a CUDA tensor goes to the hand-written kernel, a CPU tensor to
the kernel's plain PyTorch version. `Flags` holds only what a caller may choose
beyond that, and is passed explicitly down the model's apply.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

DYNAMIC_LINEAR_MODES = ("fused", "unfused")


@dataclass(frozen=True)
class Flags:
    """dynamic_linear:
        fused   - the fused dynamic-quant GEMM kernel, as the JAX package's
                  `int8_matmul_backend="pallas"` (quantnet/ops/linear.py:202-214)
        unfused - per-row dynamic_quantize, int8 GEMM kernel, f32 epilogue,
                  as the JAX package's `xla` backend (linear.py:215-226)
    plain:
        run every kernel's plain PyTorch version, on any device. A reference
        run for holding the kernels' path against; off on the serving path.
    """

    dynamic_linear: str = "fused"
    plain: bool = False

    def __post_init__(self):
        if self.dynamic_linear not in DYNAMIC_LINEAR_MODES:
            raise ValueError(
                f"dynamic_linear must be one of {DYNAMIC_LINEAR_MODES}, "
                f"got {self.dynamic_linear!r}"
            )


DEFAULT_FLAGS = Flags()


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Asking for CUDA without a card
    raises: entry points never carry on quietly on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return device
