"""The port's trainer against the JAX package's: optax's schedules and
optimizers, the augmentation, the loss, and whole Trainer runs.

The schedules and the crop / flip are bit-equal. The optimizer steps and the
Trainer runs are held to stated tolerances: gradients and global norms are
sums, which the two packages take in other orders. The Trainer runs are
augmentation-free and on a dropout-free model, since the two packages' random
streams differ (threefry against torch.Generator, ROADMAP Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quantnet.core.config import TrainConfig as JTrainConfig
from quantnet.data.datasets import make_synthetic as jmake_synthetic
from quantnet.ops import layers as jlayers
from quantnet.ops.conv import conv2d as jconv2d
from quantnet.ops.linear import linear as jlinear
from quantnet.train import trainer as jtrainer
from quantnet_torch.core.config import TrainConfig
from quantnet_torch.data.datasets import make_synthetic
from quantnet_torch.ops import layers as tlayers
from quantnet_torch.ops.conv import conv2d as tconv2d
from quantnet_torch.ops.linear import linear as tlinear
from quantnet_torch.train import trainer as ttrainer

from test_torch_convnet import jit_unfused


@pytest.mark.parametrize("lr,steps,warmup", [(0.1, 200, 0), (0.01, 1000, 0), (0.05, 37, 0),
                                             (0.1, 300, 50), (0.1, 40, 7)])
def test_schedules_bit_equal_to_optax(lr, steps, warmup):
    """Every step's learning rate, against optax's schedule jitted as the
    JAX train step runs it."""
    if warmup:
        jsched = optax.warmup_cosine_decay_schedule(lr / warmup, lr, warmup, steps)
        tsched = ttrainer.warmup_cosine_decay_schedule(lr / warmup, lr, warmup, steps)
    else:
        jsched = optax.cosine_decay_schedule(lr, steps)
        tsched = ttrainer.cosine_decay_schedule(lr, steps)
    counts = np.arange(steps + 5, dtype=np.int32)
    want = np.asarray(jit_unfused(jax.vmap(jsched), counts))
    got = np.array([tsched(int(c)) for c in counts], np.float32)
    np.testing.assert_array_equal(got, want)


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"conv": {"w": r.standard_normal((3, 3, 4, 8)).astype(np.float32),
                     "b": r.standard_normal(8).astype(np.float32)},
            "fc": {"w": r.standard_normal((16, 5)).astype(np.float32)}}


@pytest.mark.parametrize("optimizer,clip,warmup", [("sgd_cosine", 0.0, 0.0), ("sgd_cosine", 2.0, 0.5),
                                                   ("adam_plateau", 0.0, 0.0), ("adam_plateau", 2.0, 0.0)])
def test_optimizer_steps_match_optax(optimizer, clip, warmup):
    """One and five steps from the same params and gradients (the clip
    triggered on the larger gradients), against the JAX package's optax
    chain jitted; the adam lr after a plateau drop too."""
    cfg = dict(epochs=2, lr=0.05, optimizer=optimizer, grad_clip_norm=clip, warmup_epochs=warmup)
    steps_per_epoch = 4
    tx, _ = jtrainer.make_optimizer(JTrainConfig(**cfg), steps_per_epoch)
    opt = ttrainer.Optimizer(TrainConfig(**cfg), steps_per_epoch)
    jparams = _tree(0)
    tparams = jax.tree.map(torch.from_numpy, _tree(0))
    leaves = ttrainer.tensor_leaves(tparams)
    jstate, tstate = tx.init(jparams), opt.init(leaves)

    def jstep(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    jstep = jax.jit(jstep)
    for i in range(5):
        grads = jax.tree.map(lambda a: a * (3.0 if i % 2 else 0.1), _tree(100 + i))
        if i == 3 and optimizer == "adam_plateau":
            jstate[-1].hyperparams["lr"] = jstate[-1].hyperparams["lr"] * 0.5
            tstate["lr"] = float(np.float32(tstate["lr"]) * np.float32(0.5))
        jparams, jstate = jstep(jparams, jstate, grads)
        opt.update(leaves, [torch.from_numpy(g) for g in jax.tree.leaves(grads)], tstate)
        if i in (0, 4):
            for t, j in zip(leaves, jax.tree.leaves(jparams)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-6, atol=2e-7)


def test_global_norm_clip_matches_optax():
    grads = jax.tree.map(lambda a: a * 5.0, _tree(7))
    for max_norm in (0.5, 1e6):
        want, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
        got = ttrainer._global_norm_clip([torch.from_numpy(g) for g in jax.tree.leaves(grads)], max_norm)
        for t, j in zip(got, jax.tree.leaves(want)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def _jax_augment_params(key, n, rotation_deg, color_jitter):
    """augment_batch's draws from a JAX key, as it makes them."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    p = {"ys": jax.random.randint(k1, (n,), 0, 9), "xs": jax.random.randint(k2, (n,), 0, 9),
         "flip": jax.random.bernoulli(k3, 0.5, (n,))}
    if rotation_deg:
        p["angle"] = jax.random.uniform(k4, (n,), minval=-rotation_deg, maxval=rotation_deg)
    if color_jitter:
        kb, ks, kc = jax.random.split(k5, 3)
        j = color_jitter
        for name, k in (("brightness", kb), ("saturation", ks), ("contrast", kc)):
            p[name] = jax.random.uniform(k, (n, 1, 1, 1), minval=1 - j, maxval=1 + j).reshape(n)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("rotation,jitter", [(0.0, 0.0), (15.0, 0.0), (0.0, 0.2), (15.0, 0.2)])
def test_augment_matches_jax_from_its_own_draws(rotation, jitter):
    """Crop and flip bit-equal; rotation (f32 cos / sin of each package) and
    jitter within 1e-5."""
    images = np.random.default_rng(8).standard_normal((6, 12, 10, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda k, x: jtrainer.augment_batch(
        k, x, rotation_deg=rotation, color_jitter=jitter))(key, images))
    got = ttrainer.apply_augment(torch.from_numpy(images),
                                 _jax_augment_params(key, 6, rotation, jitter)).numpy()
    if rotation or jitter:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_draw_augment_ranges_and_determinism():
    p = ttrainer.draw_augment(torch.Generator().manual_seed(0), 4096, rotation_deg=15.0,
                              color_jitter=0.2)
    q = ttrainer.draw_augment(torch.Generator().manual_seed(0), 4096, rotation_deg=15.0,
                              color_jitter=0.2)
    assert all(torch.equal(p[k], q[k]) for k in p)
    assert set(p["ys"].unique().tolist()) == set(range(9)) == set(p["xs"].unique().tolist())
    assert abs(p["flip"].float().mean().item() - 0.5) < 0.03
    assert p["angle"].abs().max() <= 15.0 and p["angle"].abs().max() > 14.9
    for k in ("brightness", "saturation", "contrast"):
        assert 0.8 <= p[k].min() and p[k].max() <= 1.2


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    r = np.random.default_rng(9)
    logits = (r.standard_normal((16, 10)) * 4).astype(np.float32)
    labels = r.integers(0, 10, 16)
    want = jtrainer.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    got = ttrainer.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Whole Trainer runs: a small dropout-free model written once per package
# ---------------------------------------------------------------------------


def _tiny_params(seed=0):
    r = np.random.default_rng(seed)
    # No conv bias before the BN: its gradient is zero up to rounding noise,
    # which Adam would scale up to a full step in each package's own way.
    return ({"conv1": {"w": (r.standard_normal((3, 3, 3, 8)) * 0.3).astype(np.float32),
                       "bn": {"gamma": np.ones(8, np.float32), "beta": np.zeros(8, np.float32)}},
             "fc": {"w": (r.standard_normal((8, 4)) * 0.3).astype(np.float32),
                    "b": np.zeros(4, np.float32)}},
            {"conv1": {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}})


def _jax_tiny(params, state, x, *, train=False, rng=None, capture=None):
    y = jconv2d(params["conv1"], x)
    y, ns = jlayers.batchnorm_apply(params["conv1"]["bn"], state["conv1"], y, train=train)
    y = jlayers.maxpool2d(jax.nn.relu(y))
    return jlinear(params["fc"], y.mean(axis=(1, 2))), ({"conv1": ns} if train else state)


def _torch_tiny(params, state, x, *, train=False, generator=None, capture=None):
    y = tconv2d(params["conv1"], x)
    if train:
        y, ns = tlayers.batchnorm_train(params["conv1"]["bn"], state["conv1"], y)
        state = {"conv1": ns}
    else:
        y = tlayers.batchnorm_apply(params["conv1"]["bn"], state["conv1"], y)
    y = tlayers.maxpool2d(torch.relu(y))
    return tlinear(params["fc"], y.mean(dim=(1, 2))), state


@pytest.fixture(scope="module")
def data():
    return (jmake_synthetic(4, 8, 256, 72, seed=5, signal_max=4.0),
            make_synthetic(4, 8, 256, 72, seed=5, signal_max=4.0))


@pytest.mark.parametrize("optimizer", ["sgd_cosine", "adam_plateau"])
def test_trainer_two_epochs_match_jax(data, optimizer):
    """Two epochs (8 steps each, the test split's tail padded) from the same
    weights and batches: every epoch's losses and accuracies, the returned
    params and BN statistics."""
    (jtr, jte), (ttr, tte) = data
    np.testing.assert_array_equal(jtr.images, ttr.images)
    cfg = dict(epochs=2, batch_size=32, lr=0.05 if optimizer == "sgd_cosine" else 0.01,
               optimizer=optimizer, grad_clip_norm=1.0 if optimizer == "adam_plateau" else 0.0)
    p, s = _tiny_params()
    jt = jtrainer.Trainer(_jax_tiny, jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
                          JTrainConfig(**cfg), jtr, jte, augment=False, log=None)
    jp, js = jt.train()
    tt = ttrainer.Trainer(_torch_tiny, jax.tree.map(torch.from_numpy, p),
                          jax.tree.map(torch.from_numpy, s), TrainConfig(**cfg), ttr, tte,
                          augment=False, log=None, device="cpu")
    tp, ts = tt.train()
    for jr, tr in zip(jt.history, tt.history):
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4)
        for k in ("train_acc", "test_acc"):
            assert abs(tr[k] - jr[k]) <= 1 / 64, (k, tr[k], jr[k])
    assert tt.best_accuracy == pytest.approx(jt.best_accuracy, abs=1 / 64)
    for t, j in zip(ttrainer.tensor_leaves({"p": tp, "s": ts}), jax.tree.leaves({"p": jp, "s": js})):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-5)
    # The returned trees are copies: a further epoch leaves them alone.
    before = [t.clone() for t in ttrainer.tensor_leaves(tp)]
    tt.cfg = dataclasses.replace(tt.cfg, epochs=3)
    tt.train(reload_best=False)
    assert all(torch.equal(a, b) for a, b in zip(before, ttrainer.tensor_leaves(tp)))


def test_resume_continues_bit_for_bit(data, tmp_path):
    """An interrupted run resumed from its checkpoint ends where the
    uninterrupted one does, bit for bit (no random draws: augment off, no
    dropout)."""
    _, (ttr, tte) = data
    p, s = _tiny_params(1)
    cfg = TrainConfig(epochs=2, batch_size=32, lr=0.05)

    def trainer(epochs):
        return ttrainer.Trainer(_torch_tiny, jax.tree.map(torch.from_numpy, p),
                                jax.tree.map(torch.from_numpy, s),
                                dataclasses.replace(cfg, epochs=epochs), ttr, tte, augment=False,
                                log=None, device="cpu")

    class Interrupted(Exception):
        pass

    whole = trainer(2)
    whole.train(reload_best=False)
    first = trainer(2)
    save = first.save_checkpoint

    def save_then_stop(path, epoch):
        save(path, epoch)
        raise Interrupted

    first.save_checkpoint = save_then_stop
    with pytest.raises(Interrupted):
        first.train(save_path=str(tmp_path / "best"))
    assert (tmp_path / "best.pt").exists() and len(first.history) == 1
    resumed = trainer(2)
    logs = []
    resumed.log = logs.append
    resumed.train(save_path=str(tmp_path / "best"), resume=True, reload_best=False)
    assert logs[0].startswith("resumed from") and len(resumed.history) == 1
    for a, b in zip(ttrainer.tensor_leaves(whole.params), ttrainer.tensor_leaves(resumed.params)):
        assert torch.equal(a, b)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        trainer(2).train(save_path=str(tmp_path / "orbax"), resume=True)


def test_plateau_halves_the_lr_like_jax():
    """The port's _plateau_update against the JAX Trainer's own, on a stub
    that carries the JAX optimizer's state: the lr after every test loss."""
    cfg = dict(optimizer="adam_plateau", lr=0.01)
    tx, jplateau = jtrainer.make_optimizer(JTrainConfig(**cfg), 4)
    jparams = {"w": jnp.zeros(2)}
    jt = jtrainer.Trainer.__new__(jtrainer.Trainer)
    jt.plateau, jt.carry = jplateau, (jparams, {}, tx.init(jparams))
    opt = ttrainer.Optimizer(TrainConfig(**cfg), 4)
    t = ttrainer.Trainer.__new__(ttrainer.Trainer)
    t.plateau, t.opt_state = opt.plateau, opt.init([torch.zeros(2)])
    lrs = []
    for loss in (1.0, 0.9, 0.95, 0.95, 0.95, 0.89, 0.9, 0.9, 0.9, 0.9):
        t._plateau_update(loss)
        jt._plateau_update(loss)
        lrs.append((t.opt_state["lr"], float(jt.carry[2][1].hyperparams["lr"])))
    assert all(a == b for a, b in lrs) and lrs[-1][0] == float(np.float32(0.0025))
    assert lrs[4][0] == float(np.float32(0.005)) and lrs[3][0] == float(np.float32(0.01))


def test_save_history(tmp_path):
    t = ttrainer.Trainer.__new__(ttrainer.Trainer)
    t.history = [{"epoch": 0, "test_acc": 0.5}, {"epoch": 1, "test_acc": 0.75}]
    t.save_history(str(tmp_path / "h" / "history.jsonl"))
    assert (tmp_path / "h" / "history.jsonl").read_text().splitlines()[1] == '{"epoch": 1, "test_acc": 0.75}'
