"""Process-sharded input and the Trainer's per-rank rows, against the JAX
package (counterpart of tests/test_multiprocess.py:71-152 and of the
selection in quantnet/train/trainer.py:416-430, 505-545).

`Dataset.batches(process_shard=True, process_index=i, process_count=n)`
must give the JAX package's slices bit for bit, on the generic (f32) path
and the native loader's (uint8) path, with its errors. The Trainer's index
vectors (the shard-local shuffle's train rows and the wrap-padded eval
rows with their mask) must equal the ones the JAX Trainer hands its
sharded steps, read off a JAX Trainer on the virtual CPU mesh; each rank's
slice must equal the JAX `resident_split`'s block. Tolerance: none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.core.config import TrainConfig as JTrainConfig
from quantnet.data import datasets as jdata
from quantnet.models import convnet as jconvnet
from quantnet.parallel import mesh as jmesh
from quantnet.train import trainer as jtrainer
from quantnet_torch.data import datasets as tdata
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.parallel import steps


def _f32_pair(n=50):
    return jdata.make_synthetic(10, 8, 16, n, name="ps")[1], tdata.make_synthetic(10, 8, 16, n, name="ps")[1]


def _u8_pair(n=48):
    r = np.random.default_rng(7)
    raw = r.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
    labels = r.integers(0, 10, n).astype(np.int32)
    mk = lambda mod: mod.Dataset(None, labels, 10, "u8-ps", raw_u8=raw,  # noqa: E731
                                 mean=mod.CIFAR10_MEAN, std=mod.CIFAR10_STD)
    return mk(jdata), mk(tdata)


def _assert_same(jbatches, tbatches):
    assert len(jbatches) == len(tbatches) > 0
    for (jx, jy), (tx, ty) in zip(jbatches, tbatches):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("shuffle,drop,pad", [(True, True, False), (False, True, False),
                                              (True, False, True), (False, False, True)])
@pytest.mark.parametrize("kind", ["f32", "u8"])
def test_process_slices_bit_equal_to_jax(kind, count, shuffle, drop, pad):
    """Generic and native (uint8, shuffled, remainder dropped) paths."""
    jds, tds = _f32_pair() if kind == "f32" else _u8_pair()
    for index in range(count):
        kw = dict(shuffle=shuffle, seed=3, drop_remainder=drop, pad_remainder=pad,
                  process_shard=True, process_index=index, process_count=count)
        _assert_same(list(jds.batches(8, **kw)), list(tds.batches(8, **kw)))


def test_process_slices_cover_the_global_batches():
    _, tds = _u8_pair()
    whole = list(tds.batches(8, shuffle=True, seed=3, drop_remainder=True, process_shard=True,
                             process_index=0, process_count=1))
    parts = [list(tds.batches(8, shuffle=True, seed=3, drop_remainder=True, process_shard=True,
                              process_index=i, process_count=4)) for i in range(4)]
    # One process takes the native loader's order; four slice numpy's order.
    ref = list(tds.batches(8, shuffle=True, seed=3))
    _assert_same([(np.concatenate([p[b][0] for p in parts]), np.concatenate([p[b][1] for p in parts]))
                  for b in range(len(ref))], ref)
    assert len(whole) == len(ref) and whole[0][0].shape == (8, 16, 16, 3)
    assert parts[0][0][0].shape == (2, 16, 16, 3) and parts[0][0][0].dtype == np.float32


def test_process_shard_defaults_to_one_process():
    """Without a process group the index and count are 0 and 1."""
    _, tds = _f32_pair()
    _assert_same(list(tds.batches(8, shuffle=True, seed=1, drop_remainder=True, process_shard=True)),
                 list(tds.batches(8, shuffle=True, seed=1, drop_remainder=True)))


@pytest.mark.parametrize("kw,match", [
    (dict(process_index=0, process_count=2), "drop_remainder or pad_remainder"),
    (dict(process_index=0, process_count=2, drop_remainder=True), "not divisible"),
])
def test_process_shard_errors_match_jax(kw, match):
    jds, tds = _f32_pair()
    bs = 9 if kw.get("drop_remainder") else 8
    for ds in (jds, tds):
        with pytest.raises(ValueError, match=match):
            list(ds.batches(bs, process_shard=True, **kw))


@pytest.mark.parametrize("n,ndata", [(50, 8), (50, 2), (64, 2), (7, 4)])
def test_rank_slices_equal_jax_resident_split(n, ndata):
    """Each shard's rows, wrap-padded: the JAX resident_split's blocks."""
    jds, tds = _f32_pair(n)
    dimages, dlabels, _, _, rows = jmesh.resident_split(jmesh.make_mesh(ndata, 1), jds)
    got = [steps.resident_rows(n, ndata, d) for d in range(ndata)]
    assert all(r == rows for _, r in got)
    idx = np.concatenate([i for i, _ in got])
    np.testing.assert_array_equal(tds.take(idx), np.asarray(dimages))
    np.testing.assert_array_equal(tds.labels[idx], np.asarray(dlabels))


@pytest.mark.parametrize("n_train,n_test,bs,ndata", [(96, 50, 16, 2), (100, 37, 8, 4)])
def test_trainer_index_vectors_equal_jax(n_train, n_test, bs, ndata):
    """Two epochs of a JAX Trainer on a mesh (its steps stubbed out): every
    index vector it hands its sharded train and eval steps, against the
    port's train_selection and eval_selection."""
    train, test = jdata.make_synthetic(4, 8, n_train, n_test, name="sel")
    tp, ts = tconvnet.init(torch.Generator().manual_seed(0), num_classes=4, image_size=8, device="cpu")
    params, state = (jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree) for tree in (tp, ts))
    cfg = JTrainConfig(epochs=2, batch_size=bs, lr=0.01, seed=5)
    jt = jtrainer.Trainer(jconvnet.apply, params, state, cfg, train, test, augment=False, log=None,
                          device_data=True, mesh=jmesh.make_mesh(ndata, 1))
    seen = []
    jt._place_vec = lambda v: seen.append(np.asarray(v).copy()) or v
    jt.train_step = lambda carry, rng, *a: (carry, jnp.float32(0), jnp.float32(0))
    jt.eval_step = lambda p, s, *a: (jnp.float32(0), jnp.float32(0), jnp.float32(0), jnp.float32(1))
    jt.train(reload_best=False)
    lbs = bs // ndata
    _, rows = steps.resident_rows(n_train, ndata, 0)
    _, test_rows = steps.resident_rows(n_test, ndata, 0)
    want = []
    for epoch in range(2):
        want += steps.train_selection(rows, ndata, lbs, cfg.seed, epoch)
        for sel, valid in steps.eval_selection(test_rows, ndata, lbs, n_test):
            want += [sel, valid]
    assert len(seen) == len(want)
    for got, ref in zip(seen, want):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    # The eval mask counts every test image once.
    assert sum(v.sum() for _, v in steps.eval_selection(test_rows, ndata, lbs, n_test)) == n_test
