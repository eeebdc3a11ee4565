"""The port's data parallelism against the JAX package's (counterpart of
tests/test_parallel.py and tests/test_multiprocess.py's two-process run).

Meshes: the JAX shapes and errors, and the port's own refusals (a model
axis on a local mesh, a mesh of both kinds). One spawned two-process gloo run
(tests/torch_parallel_worker.py) is held:

  - sharded eval counts equal to the JAX `make_parallel_eval_step` on the
    virtual mesh (2 devices), and to one process's, exactly;
  - one data-parallel step of a small BN model against the JAX
    `make_parallel_train_step` within tests/test_parallel.py:105-109's
    bounds (loss 1e-4, params rtol 1e-3 / atol 1e-4), and against the
    port's one-process step on the global batch within LOSS_TIGHT, and per
    leaf RTOL_TIGHT / ATOL_TIGHT for the BN statistics and the dense layers
    (gradients and statistics summed in another order: last places); the
    conv weights lie below a max pool, where a near-tie in the last places
    can send a window's gradient to another entry, so they are held to
    RTOL_CONV (chip_smoke.py [parallel] holds the card alike);
  - one convnet step with augmentation and dropout against the port's
    one-process step on the global batch, within the same tight bounds;
  - both ranks' params bit-identical after each step and after two
    Trainer epochs, which are held against the JAX Trainer on the virtual
    mesh within tests/test_torch_trainer.py's bounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantnet.bench.benchmark import scaling_efficiency as jscaling_efficiency
from quantnet.core.config import TrainConfig as JTrainConfig
from quantnet.data.datasets import make_synthetic as jmake_synthetic
from quantnet.models import convnet as jconvnet
from quantnet.parallel import mesh as jmesh
from quantnet.parallel.steps import make_parallel_eval_step, make_parallel_train_step
from quantnet.train import trainer as jtrainer
from quantnet_torch.core.config import TrainConfig
from quantnet_torch.core.types import ActQuant, QTensor
from quantnet_torch.models import convnet as tconvnet
from quantnet_torch.parallel import mesh as meshlib
from quantnet_torch.parallel import steps
from quantnet_torch.train import trainer as ttrainer
from test_torch_trainer import _jax_tiny
from torch_ranks import spawn_pair
import torch_parallel_worker as W

LOSS_TIGHT = 1e-6
RTOL_TIGHT, ATOL_TIGHT = 1e-5, 1e-6
RTOL_CONV = 1e-2
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


# ---------------------------------------------------------------------------
# Meshes, placement
# ---------------------------------------------------------------------------


def test_mesh_shapes():
    m = meshlib.make_mesh(4, devices=[CPU] * 8)
    assert (m.kind, m.size, m.shape) == ("local", 4, {"data": 4, "model": 1})
    assert meshlib.make_mesh(-1, devices=[CPU] * 8).size == 8
    assert jmesh.make_mesh(4, 1).devices.shape == (4, 1)


def test_mesh_too_big_raises():
    with pytest.raises(ValueError, match="needs more than 8 devices"):
        meshlib.make_mesh(64, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        jmesh.make_mesh(64, 2)


def test_model_axis_refused_by_name():
    """A model axis lives on a process mesh: a local mesh refuses one."""
    with pytest.raises(ValueError, match="a local mesh has no model axis"):
        meshlib.make_mesh(2, 2, devices=[CPU] * 4)


def test_process_mesh_reports_its_shape():
    """Rank r of a 2x2 process mesh: data index r // 2, model index r % 2
    (the JAX reshape of the devices to (dp, mp)); tests/test_torch_dryrun.py
    spawns the four ranks."""
    m = meshlib.Mesh("processes", (CPU,), 2, 1, "gloo", 2, 0)
    assert m.shape == {"data": 2, "model": 2} == dict(zip(("data", "model"),
                                                          jmesh.make_mesh(2, 2).devices.shape))
    assert meshlib.shard_batch(m, np.arange(8)).tolist() == [4, 5, 6, 7]


def test_backend_choice(monkeypatch):
    assert meshlib.pick_backend("cpu", 2, 1) == ("gloo", CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert meshlib.pick_backend("cuda", 2, 1) == ("gloo", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert meshlib.pick_backend("cuda", 2, 1) == ("nccl", torch.device("cuda", 1))


def test_one_process_joins_nothing():
    assert meshlib.init_distributed(num_processes=1, device="cpu") == CPU
    assert meshlib.process_count() == 1 and meshlib.process_index() == 0


def test_shard_batch_splits_rows():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    parts = meshlib.shard_batch(meshlib.make_mesh(devices=[CPU] * 3), (x, x[:, 0]))
    assert [p.tolist() for p in parts[1]] == [[0.0, 4.0], [8.0, 12.0], [16.0, 20.0]]
    rank1 = meshlib.Mesh("processes", (CPU,), 2, 1)
    assert meshlib.shard_batch(rank1, x).tolist() == x[3:].tolist()
    with pytest.raises(ValueError, match="does not divide"):
        meshlib.shard_batch(rank1, x[:5])


def test_replicate_gives_independent_copies_with_gemm_constants():
    from quantnet_torch.quantize import static
    from quantnet_torch.quantize.fold import fold_model

    p, s = tconvnet.init(torch.Generator().manual_seed(0), image_size=8, device="cpu")
    fp, fs = fold_model(p, s)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8, 8, 3)).astype(np.float32))
    q, _ = static.bake(fp, fs, static.calibrate(tconvnet.apply, fp, fs, [x]))
    copies = meshlib.replicate(meshlib.make_mesh(devices=[CPU, CPU]), q)
    assert len(copies) == 2
    a, b = copies
    assert isinstance(a["conv2"]["w"], QTensor) and isinstance(a["conv2"]["aq"], ActQuant)
    assert a["conv2"]["w"].values.data_ptr() != q["conv2"]["w"].values.data_ptr()
    assert a["conv2"]["w"].values.data_ptr() != b["conv2"]["w"].values.data_ptr()
    assert list(a) == list(q) and "gemm" in a["conv2"]
    want = tconvnet.apply(q, {}, x)[0]
    assert all(torch.equal(tconvnet.apply(c, {}, x)[0], want) for c in copies)


def test_steps_refuse_a_local_mesh_of_several_devices():
    with pytest.raises(ValueError, match="one device a process"):
        steps.check_step_mesh(meshlib.make_mesh(devices=[CPU, CPU]))
    steps.check_step_mesh(meshlib.make_mesh(devices=[CPU]))


# ---------------------------------------------------------------------------
# Two ranks over gloo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_mp")
    logs = spawn_pair("torch_parallel_worker.py", out)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)], logs, out


def test_process_mesh_and_refusals(ranks):
    (r0, r1), logs, _ = ranks
    assert r0["mesh"] == ("processes", 2, 0, "gloo", "cpu") and r1["mesh"][2] == 1
    assert all("backend gloo (the CPU)" in log for log in logs)
    for r in (r0, r1):
        assert "not both" in r["refused"]["both"]
        assert "spans all 2 ranks" in r["refused"]["partial"]
        assert "need a mesh" in r["refused"]["trainer"]


def _jax_params(tree_np):
    return jax.tree.map(jnp.asarray, tree_np)


def test_eval_counts_equal_jax_mesh_and_one_process(ranks):
    (r0, r1), _, _ = ranks
    assert np.array_equal(r0["eval"], r1["eval"])
    tp, ts = tconvnet.init(torch.Generator().manual_seed(W.CONVNET_SEED), image_size=W.IMAGE,
                           device="cpu")
    jp, js = _jax_params(_np(tp)), _jax_params(_np(ts))
    _, test = jmake_synthetic(10, W.IMAGE, 8, 64, seed=11)
    mesh = jmesh.make_mesh(2, 1)
    want = np.zeros(3, np.int64)
    with mesh:
        step = make_parallel_eval_step(jconvnet.apply, mesh, 10)
        p, s = jmesh.shard_params(mesh, jp), jmesh.shard_params(mesh, js)
        for x, y in test.batches(W.GLOBAL_BS, drop_remainder=True):
            t1, t5, n = step(p, s, *jmesh.shard_batch(mesh, (x, y)))
            want += [int(t1), int(t5), int(n)]
    np.testing.assert_array_equal(r0["eval"], want)
    one = meshlib.make_mesh(devices=[CPU])
    single = np.zeros(3, np.int64)
    for x, y in test.batches(W.GLOBAL_BS, drop_remainder=True):
        o = steps.eval_step(one, tconvnet.apply, tp, ts, torch.from_numpy(x), torch.from_numpy(y).long())
        single += [o["top1"], o["top5"], o["n"]]
    np.testing.assert_array_equal(r0["eval"], single)


def _leaves(tree):
    return ttrainer.tensor_leaves(tree)


def _one_process_step(apply_fn, params, state, images, labels, seed=W.STEP_SEED, **kw):
    opt = ttrainer.Optimizer(TrainConfig(**W.TINY_CFG), 10)
    p = ttrainer.clone_tree(params, requires_grad=True)
    leaves = _leaves(p)
    opt_state = opt.init(leaves)
    gen = torch.Generator().manual_seed(seed)
    new_state, loss, _ = ttrainer.train_step(apply_fn, opt, p, state, opt_state, leaves, gen,
                                             torch.from_numpy(images), torch.from_numpy(labels), **kw)
    return ttrainer.clone_tree(p), new_state, float(loss)


def _assert_ranks_identical(a, b):
    for x, y in zip(_leaves({"p": a["params"], "s": a["state"]}), _leaves({"p": b["params"], "s": b["state"]})):
        assert torch.equal(x, y)
    assert torch.equal(a["loss"], b["loss"])


def _names(tree, prefix=""):
    return [n for k in sorted(tree) for n in (_names(tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict)
                                             else [prefix + k] if isinstance(tree[k], torch.Tensor) else [])]


def _assert_tight(dp, params, state, loss):
    assert abs(float(dp["loss"]) - loss) <= LOSS_TIGHT * max(abs(loss), 1.0)
    want_tree = {"p": params, "s": state}
    for name, got, want in zip(_names(want_tree), _leaves({"p": dp["params"], "s": dp["state"]}),
                               _leaves(want_tree)):
        got, want = got.detach().numpy(), want.detach().numpy()
        rtol = RTOL_CONV if name.startswith("p.conv") else RTOL_TIGHT
        assert np.abs(got - want).max() <= rtol * np.abs(want).max() + ATOL_TIGHT, name


def test_tiny_step_matches_jax_mesh_step_and_one_process(ranks):
    """BN over the global batch (two ranks of 8 rows), gradients averaged."""
    (r0, r1), _, _ = ranks
    _assert_ranks_identical(r0["tiny_step"], r1["tiny_step"])
    tp, ts = W.tiny_params()
    images, labels = W.tiny_batch()
    tx, _ = jtrainer.make_optimizer(JTrainConfig(**W.TINY_CFG), 10)
    mesh = jmesh.make_mesh(2, 1)
    with mesh:
        p = jmesh.shard_params(mesh, _jax_params(tp))
        s = jmesh.shard_params(mesh, _jax_params(ts))
        step = make_parallel_train_step(_jax_tiny, tx, mesh, augment=False)
        im, lb = jmesh.shard_batch(mesh, (images, labels.astype(np.int32)))
        (jp, js, _), jloss, _ = step((p, s, tx.init(p)), jax.random.PRNGKey(0), im, lb)
    dp = r0["tiny_step"]
    assert abs(float(dp["loss"]) - float(jloss)) < 1e-4
    for got, want in zip(_leaves({"p": dp["params"], "s": dp["state"]}),
                         jax.tree.leaves({"p": jp, "s": js})):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    _assert_tight(dp, *_one_process_step(W.torch_tiny, W._tree(tp), W._tree(ts), images, labels,
                                         augment=False))


def test_convnet_step_with_augmentation_and_dropout_matches_one_process(ranks):
    """The ranks draw the global batch's crops, flips, rotations, jitter and
    dropout masks, each its rows: one process's step on the global batch."""
    (r0, r1), _, _ = ranks
    _assert_ranks_identical(r0["convnet_step"], r1["convnet_step"])
    tp, ts = tconvnet.init(torch.Generator().manual_seed(W.CONVNET_SEED), image_size=W.IMAGE,
                           device="cpu")
    images, labels = W.convnet_batch()
    params, state, loss = _one_process_step(tconvnet.apply, tp, ts, images, labels, augment=True,
                                            rotation_deg=15.0, color_jitter=0.2)
    _assert_tight(r0["convnet_step"], params, state, loss)
    # Other draws (another seed) give another step: the check sees the draws.
    _, _, other = _one_process_step(tconvnet.apply, tp, ts, images, labels, seed=W.STEP_SEED + 1,
                                    augment=True, rotation_deg=15.0, color_jitter=0.2)
    assert abs(other - loss) > 1e-4


def test_trainer_over_two_ranks_matches_jax_mesh_trainer(ranks):
    (r0, r1), logs, out = ranks
    a, b = r0["trainer"], r1["trainer"]
    for x, y in zip(_leaves({"p": a["params"], "s": a["state"]}), _leaves({"p": b["params"], "s": b["state"]})):
        assert torch.equal(x, y)
    assert [h["test_acc"] for h in a["history"]] == [h["test_acc"] for h in b["history"]]
    # Rank 0 alone logs and writes its checkpoint.
    assert "epoch 1:" in logs[0] and "epoch" not in logs[1]
    assert (out / "ckpt0.pt").exists() and not (out / "ckpt1.pt").exists()
    jtr, jte = jmake_synthetic(4, 8, 96, 37, seed=5, signal_max=4.0)
    tp, ts = W.tiny_params()
    jt = jtrainer.Trainer(_jax_tiny, _jax_params(tp), _jax_params(ts), JTrainConfig(**W.TRAINER_CFG),
                          jtr, jte, augment=False, log=None, device_data=True,
                          mesh=jmesh.make_mesh(2, 1))
    jp, js = jt.train()
    for jr, tr in zip(jt.history, a["history"]):
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4)
        for k in ("train_acc", "test_acc"):
            assert abs(tr[k] - jr[k]) <= 1 / 64, (k, tr[k], jr[k])
    assert a["best_accuracy"] == pytest.approx(jt.best_accuracy, abs=1 / 64)
    for t, j in zip(_leaves({"p": a["params"], "s": a["state"]}), jax.tree.leaves({"p": jp, "s": js})):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-5)


def test_trainer_on_one_device_mesh_is_the_one_process_trainer():
    """A mesh of one device runs the data-parallel path; with one rank its
    epochs are the shard-local shuffle's, so it is held to the JAX Trainer
    on a one-device mesh."""
    train, test = W.trainer_data()
    tp, ts = W.tiny_params()
    cfg = dataclasses.replace(TrainConfig(**W.TRAINER_CFG), epochs=1)
    tt = ttrainer.Trainer(W.torch_tiny, W._tree(tp), W._tree(ts), cfg, train, test, augment=False,
                          log=None, mesh=meshlib.make_mesh(devices=[CPU]))
    tt.train()
    jtr, jte = jmake_synthetic(4, 8, 96, 37, seed=5, signal_max=4.0)
    jt = jtrainer.Trainer(_jax_tiny, _jax_params(tp), _jax_params(ts),
                          JTrainConfig(**{**W.TRAINER_CFG, "epochs": 1}), jtr, jte, augment=False,
                          log=None, device_data=True, mesh=jmesh.make_mesh(1, 1))
    jt.train()
    np.testing.assert_allclose(tt.history[0]["train_loss"], jt.history[0]["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(tt.history[0]["test_loss"], jt.history[0]["test_loss"], rtol=1e-4)


# ---------------------------------------------------------------------------
# Scaling
# ---------------------------------------------------------------------------


def test_scaling_efficiency_equals_jax():
    tp = {1: 1000.0, 2: 1900.0, 4: 3500.5, 8: 6001.25}
    from quantnet_torch.bench.scaling import scaling_efficiency

    assert scaling_efficiency(tp) == jscaling_efficiency(tp)
    assert scaling_efficiency({2: 5.0}) == jscaling_efficiency({2: 5.0}) == {}


def test_mesh_sizes_equal_jax():
    from quantnet.bench.scaling import _mesh_sizes as jsizes
    from quantnet_torch.bench.scaling import mesh_sizes

    assert all(mesh_sizes(n) == jsizes(n) for n in (1, 2, 3, 6, 8, 12))


def test_measure_scaling_over_two_cpu_shards():
    from quantnet_torch.bench.scaling import measure_scaling

    tp, ts = tconvnet.init(torch.Generator().manual_seed(0), image_size=8, device="cpu")
    res = measure_scaling(tconvnet.apply, tp, ts, image_size=8, per_device_batch=4, iters=2, windows=1,
                          devices=[CPU, CPU])
    assert set(res["throughput"]) == {1, 2} and all(v > 0 for v in res["throughput"].values())
    assert res["efficiency"][1] == 1.0 and res["device"] == "cpu"
