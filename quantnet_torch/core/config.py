"""Backend selection and device checks (counterpart of quantnet/core/config.py).

The JAX package picks a backend from a global flag object. Here the tensor's
device picks it: a CUDA tensor goes to the hand-written kernel, a CPU tensor to
the kernel's plain PyTorch version. `Flags` holds only what a caller may choose
beyond that, and is passed explicitly down the model's apply. `TrainConfig`
is the trainer's.
"""
from __future__ import annotations

import contextlib
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
    fake_quant_identity:
        in a QAT tree's forward, fake-quantize each residual identity in its
        block input's domain, as the baked tree reads that input (int8,
        dequantized). The fake-quant graph that a bake deploys, for holding
        the baked tree against; training adds the identity unquantized, as
        the JAX package does.
    """

    dynamic_linear: str = "fused"
    plain: bool = False
    fake_quant_identity: bool = False

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


@dataclass(frozen=True)
class TrainConfig:
    """The trainer's settings (quantnet/core/config.py:104-130), with the
    JAX package's defaults.

    optimizer: sgd_cosine (SGD, momentum, weight decay, cosine annealing over
    `epochs`, an optional linear warmup of `warmup_epochs`) or adam_plateau
    (Adam, its lr halved when the test loss stalls for 2 epochs).
    aug_rotation_deg / aug_color_jitter add the reference transform's
    rotation and colour jitter to the random crop and flip; grad_clip_norm
    > 0 clips the gradients' global norm (the QAT finetune sets 1.0).
    """

    epochs: int = 20
    batch_size: int = 128
    lr: float = 0.1
    optimizer: str = "sgd_cosine"
    momentum: float = 0.9
    weight_decay: float = 5e-4
    label_smoothing: float = 0.0
    seed: int = 0
    save_dir: str = "./saved_models"
    log_every: int = 50
    aug_rotation_deg: float = 0.0
    aug_color_jitter: float = 0.0
    warmup_epochs: float = 0.0
    grad_clip_norm: float = 0.0


@contextlib.contextmanager
def no_tf32():
    """f32 products kept f32 for everything inside: cuDNN's convs and cuBLAS's
    matmuls, forward and backward, take TF32 by default on the card. The
    train step runs inside this scope, as the JAX package's QAT ops compute
    at Precision.HIGHEST (quantnet/ops/conv.py:216-222); the caller's
    settings come back after it."""
    cudnn, cublas = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.allow_tf32, cublas.allow_tf32
    cudnn.allow_tf32 = cublas.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, cublas.allow_tf32 = before
