"""Data: CIFAR-10 and its deterministic synthetic fallback (the port's own
copy of quantnet/data/datasets.py:66-337).

The arrays are numpy, NHWC f32, and bit for bit the JAX package's from the
same seed. `Dataset.batches` gives the JAX package's batches in its order,
shuffled epochs included (data/loader.py). Real CIFAR-10 is read from the python-pickle batches
(`cifar-10-batches-py`) where they are on disk; otherwise `load_cifar10`
returns the synthetic class-conditional task, so nothing is downloaded. The
ImageNet loader is not ported yet (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from quantnet_torch.data.loader import prefetch, shuffled_indices

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

    def take(self, sel: np.ndarray) -> np.ndarray:
        """The f32 images at indices `sel`, as a batch of them is assembled."""
        if self.raw_u8 is None:
            return self.images[sel]
        # The JAX package's native batch assembler, as its compiler builds it:
        # fma(px, f32(1/255), -mean) * f32(1 / std). The fused multiply-add
        # rounds once; in float64 the product and the sum are exact, so one
        # rounding to f32 gives the same bits.
        r255 = np.float64(np.float32(1) / np.float32(255))
        v = (self.raw_u8[sel].astype(np.float64) * r255 - self.mean.astype(np.float64)).astype(np.float32)
        return v * (np.float32(1) / self.std)

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
        pad_remainder: bool = False,
        process_shard: bool = False,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images, labels), as quantnet/data/datasets.py:147-227 does.
        shuffle takes numpy's default_rng(seed) order, but a uint8 split's
        training epoch in one process (shuffle and drop_remainder) takes the
        native loader's order and is assembled a batch ahead on a thread.
        With pad_remainder the last batch is filled up by wrapping to the
        first examples (fixed shapes); callers that count use `len(self)` to
        cut the tail.

        process_shard: batch_size is the global batch; every process walks
        the same seeded global order and yields its contiguous
        batch_size / process_count rows of each global batch. The index and
        count default to the process group's rank and size (0 and 1 without
        one). A uint8 split's slices of a shuffled, remainder-dropped epoch
        are assembled a batch ahead on a thread, as the native loader's are."""
        n = len(self)
        pi = pc = None
        if process_shard:
            from quantnet_torch.parallel.mesh import process_count as count, process_index as index

            pc = process_count if process_count is not None else count()
            pi = process_index if process_index is not None else index()
            if batch_size % pc:
                raise ValueError(f"global batch {batch_size} not divisible by {pc} processes")
            if not (drop_remainder or pad_remainder):
                raise ValueError("process_shard requires drop_remainder or pad_remainder (every "
                                 "process must see the same number of equal batches)")
        sharded = bool(pc and pc > 1)
        if self.raw_u8 is not None and shuffle and drop_remainder and not sharded:
            idx = shuffled_indices(n, seed)
            sels = [idx[s : s + batch_size] for s in range(0, n - n % batch_size, batch_size)]
            yield from prefetch((self.take(sel), self.labels[sel]) for sel in sels)
            return
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        end = n - (n % batch_size) if drop_remainder else n
        sels = []
        for start in range(0, end, batch_size):
            sel = idx[start : start + batch_size]
            if len(sel) < batch_size and pad_remainder:
                sel = np.concatenate([sel, idx[: batch_size - len(sel)]])
            if sharded:
                lbs = batch_size // pc
                sel = sel[pi * lbs : (pi + 1) * lbs]
            sels.append(sel)
        if self.raw_u8 is not None and drop_remainder and sharded:
            yield from prefetch((self.take(sel), self.labels[sel]) for sel in sels)
            return
        for sel in sels:
            yield self.take(sel), self.labels[sel]


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
