"""The port's epoch order and batches against the JAX package's data
pipeline: `shuffled_indices` in both of the JAX NativeBatcher's branches
(its C++ library built, and absent), and `Dataset.batches` on float and
uint8 splits, bit for bit."""
import numpy as np
import pytest

from quantnet.data import native_loader as jnative
from quantnet.data.datasets import Dataset as JDataset
from quantnet_torch.data import loader as tloader
from quantnet_torch.data.datasets import Dataset as TDataset

MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def _u8(n, seed=0):
    r = np.random.default_rng(seed)
    return (r.integers(0, 256, (n, 6, 5, 3)).astype(np.uint8), r.integers(0, 10, n).astype(np.int32))


@pytest.fixture(scope="module")
def batcher():
    images, labels = _u8(1000)
    nb = jnative.NativeBatcher(images, labels, MEAN, STD)
    if nb.lib is None:
        pytest.fail("the JAX package's native library did not build (g++ missing?)")
    return nb


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**40 + 3])
def test_shuffle_matches_the_native_library(batcher, seed):
    np.testing.assert_array_equal(tloader.shuffled_indices(len(batcher), seed),
                                  batcher.shuffled_indices(seed))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_shuffle_matches_the_numpy_branch(batcher, monkeypatch, seed):
    monkeypatch.setattr(batcher, "lib", None)
    np.testing.assert_array_equal(tloader.shuffled_indices(len(batcher), seed, native=False),
                                  batcher.shuffled_indices(seed))


def test_xorshift_matches_the_python_fallback():
    x = 0x9E3779B97F4A7C15
    for _ in range(100):
        assert tloader.xorshift(x) == jnative._xorshift(x)
        x = tloader.xorshift(x)


@pytest.mark.parametrize("kind", ["float", "u8"])
@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, seed=3, drop_remainder=True),
                                dict(shuffle=True, seed=4), dict(pad_remainder=True),
                                dict(drop_remainder=True)])
def test_batches_match_jax(kind, kw):
    """The same batches in the same order: a uint8 training epoch (shuffle and
    drop_remainder) in the native library's order, assembled a batch ahead."""
    if kind == "float":
        x = np.random.default_rng(1).standard_normal((203, 4, 4, 3)).astype(np.float32)
        y = np.arange(203, dtype=np.int32) % 10
        j, t = JDataset(x, y, 10, "f"), TDataset(x, y, 10, "f")
    else:
        x, y = _u8(203, 2)
        j = JDataset(None, y, 10, "u", raw_u8=x, mean=MEAN, std=STD)
        t = TDataset(None, y, 10, "u", raw_u8=x, mean=MEAN, std=STD)
    jb, tb = list(j.batches(32, **kw)), list(t.batches(32, **kw))
    assert len(jb) == len(tb) > 0
    for (ji, jl), (ti, tl) in zip(jb, tb):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_prefetch_keeps_order_and_raises():
    assert list(tloader.prefetch(iter(range(10)))) == list(range(10))

    def broken():
        yield 1
        raise RuntimeError("bad batch")

    it = tloader.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="bad batch"):
        next(it)
