"""Host-side data: CIFAR-10 and its deterministic synthetic fallback (the
port's own copy of quantnet/data/datasets.py:66-337, host side only).

The arrays are numpy, NHWC f32, and bit for bit the JAX package's from the
same seed; the evaluator moves each batch to the device. Real CIFAR-10 is
read from the python-pickle batches (`cifar-10-batches-py`) where they are on
disk; otherwise `load_cifar10` returns the synthetic class-conditional task,
so nothing is downloaded. The ImageNet loader comes with the ResNet's
evaluation.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

CIFAR10_CLASSES = (
    "plane", "car", "bird", "cat", "deer", "dog", "frog", "horse", "ship", "truck",
)
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


@dataclass
class Dataset:
    """An in-memory split: int32 labels and either normalized f32 NHWC
    `images`, or raw uint8 `raw_u8` with per-channel `mean` / `std` that
    batches are normalized with as they are assembled."""

    images: Optional[np.ndarray]
    labels: np.ndarray
    num_classes: int
    name: str
    raw_u8: Optional[np.ndarray] = None
    mean: Optional[np.ndarray] = None
    std: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.labels.shape[0]

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        """(H, W, C) of one image."""
        return tuple((self.images if self.raw_u8 is None else self.raw_u8).shape[1:])

    def _gather(self, sel: np.ndarray) -> np.ndarray:
        if self.raw_u8 is None:
            return self.images[sel]
        # The JAX package's native batch assembler, as its compiler builds it:
        # fma(px, f32(1/255), -mean) * f32(1 / std). The fused multiply-add
        # rounds once; in float64 the product and the sum are exact, so one
        # rounding to f32 gives the same bits.
        r255 = np.float64(np.float32(1) / np.float32(255))
        v = (self.raw_u8[sel].astype(np.float64) * r255 - self.mean.astype(np.float64)).astype(np.float32)
        return v * (np.float32(1) / self.std)

    def batches(self, batch_size: int, *, pad_remainder: bool = False) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images, labels) in order. With pad_remainder the last batch
        is filled up by wrapping to the first examples (fixed shapes); callers
        that count use `len(self)` to cut the tail."""
        n = len(self)
        idx = np.arange(n)
        for start in range(0, n, batch_size):
            sel = idx[start : start + batch_size]
            if len(sel) < batch_size and pad_remainder:
                sel = np.concatenate([sel, idx[: batch_size - len(sel)]])
            yield self._gather(sel), self.labels[sel]


def _find_cifar10_dir(data_dir: str) -> Optional[str]:
    for cand in (os.path.join(data_dir, "cifar-10-batches-py"), data_dir):
        if os.path.isfile(os.path.join(cand, "data_batch_1")):
            return cand
    return None


def _load_cifar10_real(batch_dir: str) -> Tuple[Dataset, Dataset]:
    def load_file(path):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        return d[b"data"], np.asarray(d[b"labels"], np.int32)

    xs, ys = zip(*(load_file(os.path.join(batch_dir, f"data_batch_{i}")) for i in range(1, 6)))
    xte, yte = load_file(os.path.join(batch_dir, "test_batch"))

    def prep(x):
        return np.ascontiguousarray(x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))

    return (
        Dataset(None, np.concatenate(ys), 10, "cifar10-train", raw_u8=prep(np.concatenate(xs)),
                mean=CIFAR10_MEAN, std=CIFAR10_STD),
        Dataset(None, yte, 10, "cifar10-test", raw_u8=prep(xte), mean=CIFAR10_MEAN, std=CIFAR10_STD),
    )


def make_synthetic(
    num_classes: int,
    image_size: int,
    train_size: int,
    test_size: int,
    seed: int = 1234,
    name: str = "synthetic",
    *,
    patch_frac: float = 0.375,
    signal_max: float = 2.5,
) -> Tuple[Dataset, Dataset]:
    """Deterministic class-conditional images that do not saturate: each
    class has a fixed random patch (side patch_frac * image_size); a sample
    is unit gaussian noise plus its class's patch at a random position, with
    an amplitude drawn uniformly from [0, signal_max]."""
    rng = np.random.default_rng(seed)
    ps = max(int(round(image_size * patch_frac)), 4)
    protos = rng.normal(0.0, 1.0, (num_classes, ps, ps, 3)).astype(np.float32)

    def split(n, sseed):
        r = np.random.default_rng(sseed)
        labels = r.integers(0, num_classes, n).astype(np.int32)
        images = r.normal(0.0, 1.0, (n, image_size, image_size, 3)).astype(np.float32)
        amp = r.uniform(0.0, signal_max, n).astype(np.float32)
        ys = r.integers(0, image_size - ps + 1, n)
        xs = r.integers(0, image_size - ps + 1, n)
        for i in range(n):
            images[i, ys[i] : ys[i] + ps, xs[i] : xs[i] + ps, :] += amp[i] * protos[labels[i]]
        return images, labels

    xtr, ytr = split(train_size, seed + 1)
    xte, yte = split(test_size, seed + 2)
    return (
        Dataset(xtr, ytr, num_classes, f"{name}-train"),
        Dataset(xte, yte, num_classes, f"{name}-test"),
    )


def load_cifar10(
    data_dir: str = "./data",
    *,
    synthetic_train_size: int = 12800,
    synthetic_test_size: int = 2560,
) -> Tuple[Dataset, Dataset]:
    """CIFAR-10 train / test; the synthetic task when no batches are on disk."""
    real = _find_cifar10_dir(data_dir)
    if real is not None:
        return _load_cifar10_real(real)
    return make_synthetic(10, 32, synthetic_train_size, synthetic_test_size, name="cifar10-synthetic")
