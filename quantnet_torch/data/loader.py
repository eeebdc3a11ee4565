"""Epoch order and prefetch (the port's copy of quantnet/data/native_loader.py:
86-93, 181-245).

The JAX package shuffles a uint8 split with its C++ library's xorshift64*
Fisher-Yates (native/dataloader.cpp:124-134) when that library builds, and
with numpy's `default_rng(seed).shuffle` when it does not; a float split
always takes numpy's. `shuffled_indices` gives either permutation, bit for
bit, in Python. `prefetch` assembles the next batch on a thread while the
caller runs the current step, as the native loader's one-deep prefetch does.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np

_MASK = (1 << 64) - 1


def xorshift(x: int) -> int:
    """xorshift64* (native/dataloader.cpp)."""
    x &= _MASK
    x ^= x >> 12
    x ^= (x << 25) & _MASK
    x ^= x >> 27
    return (x * 0x2545F4914F6CDD1D) & _MASK


def shuffled_indices(n: int, seed: int, *, native: bool = True) -> np.ndarray:
    """int64[n], a permutation of range(n): the C++ library's Fisher-Yates
    seeded with `seed or 1` (native=True, the branch the JAX package takes
    wherever g++ builds its library), or numpy's default_rng(seed) shuffle
    (native=False, its branch without the library)."""
    if not native:
        idx = np.arange(n, dtype=np.int64)
        np.random.default_rng(seed).shuffle(idx)
        return idx
    idx = list(range(n))
    r = (seed or 1) & _MASK
    for i in range(n - 1, 0, -1):
        r = xorshift(r)
        j = r % (i + 1)
        idx[i], idx[j] = idx[j], idx[i]
    return np.asarray(idx, dtype=np.int64)


def prefetch(items: Iterable) -> Iterator:
    """Yield `items`, each made on a thread one ahead of the one the caller
    holds. An exception in the thread is raised in the caller."""
    q: "queue.Queue" = queue.Queue(maxsize=1)
    done = object()

    def producer():
        try:
            for item in items:
                q.put((True, item))
        except BaseException as e:  # handed to the consumer
            q.put((False, e))
            return
        q.put((True, done))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        ok, item = q.get()
        if not ok:
            t.join()
            raise item
        if item is done:
            break
        yield item
    t.join()
