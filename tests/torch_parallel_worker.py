"""One rank of the two-process data-parallel run (tests/test_torch_parallel.py).

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT_DIR

Joins a gloo group on the CPU and writes to OUT_DIR/rank<RANK>.pt what the
parent holds against the JAX package and the port's one-process steps:

  - eval: the fp32 convnet's (16x16, seeded) sharded top-1 / top-5 / rows
    over the synthetic test split, global batch 16 (process_shard slices);
  - tiny_step: one data-parallel step of a small BN model (no dropout,
    augmentation off) on this rank's half of a global batch of 16;
  - convnet_step: one data-parallel convnet step with augmentation and
    dropout, from seeded weights and a generator seeded alike on each rank;
  - trainer: two epochs of the Trainer over the process mesh on the small
    BN model, its history and params; rank 0 alone logs and writes its
    checkpoint;
  - refused: the errors of a mesh that asks for both kinds, and of a
    Trainer without a mesh under several processes.

The small model and the seeds are defined here, so the parent builds the
same inputs.
"""
import sys

import numpy as np
import torch

from quantnet_torch.core.config import TrainConfig
from quantnet_torch.data.datasets import make_synthetic
from quantnet_torch.models import convnet
from quantnet_torch.ops import layers
from quantnet_torch.ops.conv import conv2d
from quantnet_torch.ops.linear import linear
from quantnet_torch.parallel import mesh as meshlib
from quantnet_torch.parallel import steps
from quantnet_torch.train import trainer as ttrainer

GLOBAL_BS = 16
IMAGE = 16
TINY_CFG = dict(epochs=1, batch_size=GLOBAL_BS, lr=0.05)
CONVNET_SEED = 0
STEP_SEED = 7


def tiny_params(seed=0):
    """A conv -> BN -> relu -> pool -> mean -> fc model's numpy weights
    (tests/test_torch_trainer.py's small model)."""
    r = np.random.default_rng(seed)
    return ({"conv1": {"w": (r.standard_normal((3, 3, 3, 8)) * 0.3).astype(np.float32),
                       "bn": {"gamma": np.ones(8, np.float32), "beta": np.zeros(8, np.float32)}},
             "fc": {"w": (r.standard_normal((8, 4)) * 0.3).astype(np.float32),
                    "b": np.zeros(4, np.float32)}},
            {"conv1": {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}})


def torch_tiny(params, state, x, *, train=False, generator=None, capture=None):
    y = conv2d(params["conv1"], x)
    if train:
        y, ns = layers.batchnorm_train(params["conv1"]["bn"], state["conv1"], y)
        state = {"conv1": ns}
    else:
        y = layers.batchnorm_apply(params["conv1"]["bn"], state["conv1"], y)
    y = layers.maxpool2d(torch.relu(y))
    return linear(params["fc"], y.mean(dim=(1, 2))), state


def tiny_batch():
    r = np.random.default_rng(1)
    return (r.standard_normal((GLOBAL_BS, IMAGE, IMAGE, 3)).astype(np.float32),
            r.integers(0, 4, GLOBAL_BS).astype(np.int64))


def convnet_batch():
    r = np.random.default_rng(2)
    return (r.standard_normal((GLOBAL_BS, IMAGE, IMAGE, 3)).astype(np.float32),
            r.integers(0, 10, GLOBAL_BS).astype(np.int64))


def trainer_data():
    """(train, test): 4 classes at 8x8, as tests/test_torch_trainer.py's."""
    return make_synthetic(4, 8, 96, 37, seed=5, signal_max=4.0)


TRAINER_CFG = dict(epochs=2, batch_size=16, lr=0.05)


def _tree(np_tree):
    return {k: _tree(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in np_tree.items()}


def _one_step(mesh, apply_fn, params, state, images, labels, cfg, **kw):
    opt = ttrainer.Optimizer(cfg, 10)
    p = ttrainer.clone_tree(params, requires_grad=True)
    leaves = ttrainer.tensor_leaves(p)
    opt_state = opt.init(leaves)
    gen = torch.Generator().manual_seed(STEP_SEED)
    new_state, loss, acc = steps.train_step(mesh, apply_fn, opt, p, state, opt_state, leaves, gen,
                                            images, labels, **kw)
    return {"params": ttrainer.clone_tree(p), "state": new_state, "loss": loss, "acc": acc}


def main(rank: int, world: int, port: int, out: str) -> None:
    device = meshlib.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    mesh = meshlib.make_mesh()
    result = {"mesh": (mesh.kind, mesh.size, mesh.rank, mesh.backend, str(device))}
    refused = {}
    for name, call in (("both", lambda: meshlib.make_mesh(devices=["cpu"])),
                       ("partial", lambda: meshlib.make_mesh(1))):
        try:
            call()
        except ValueError as e:
            refused[name] = str(e)

    # Sharded evaluation of the fp32 convnet.
    params, state = convnet.init(torch.Generator().manual_seed(CONVNET_SEED), image_size=IMAGE,
                                 device="cpu")
    _, test = make_synthetic(10, IMAGE, 8, 64, seed=11)
    counts = np.zeros(3, np.int64)
    for x, y in test.batches(GLOBAL_BS, process_shard=True, drop_remainder=True):
        assert x.shape[0] == GLOBAL_BS // world
        out_ = steps.eval_step(mesh, convnet.apply, params, state, torch.from_numpy(x),
                               torch.from_numpy(y).long())
        counts += [out_["top1"], out_["top5"], out_["n"]]
    result["eval"] = counts

    # One step of the small BN model, augmentation off.
    images, labels = meshlib.shard_batch(mesh, tiny_batch())
    tp, ts = tiny_params()
    result["tiny_step"] = _one_step(mesh, torch_tiny, _tree(tp), _tree(ts), images, labels,
                                    TrainConfig(**TINY_CFG), augment=False)

    # One convnet step with augmentation (rotation and jitter too) and dropout.
    images, labels = meshlib.shard_batch(mesh, convnet_batch())
    result["convnet_step"] = _one_step(mesh, convnet.apply, params, state, images, labels,
                                       TrainConfig(**TINY_CFG), augment=True, rotation_deg=15.0,
                                       color_jitter=0.2)

    # The Trainer over the process mesh.
    train, test = trainer_data()
    tp, ts = tiny_params()
    try:
        ttrainer.Trainer(torch_tiny, _tree(tp), _tree(ts), TrainConfig(**TRAINER_CFG), train, test,
                         augment=False, log=None, device="cpu")
    except ValueError as e:
        refused["trainer"] = str(e)
    # Rank 0 prints its epochs; rank 1 is silent.
    tr = ttrainer.Trainer(torch_tiny, _tree(tp), _tree(ts), TrainConfig(**TRAINER_CFG), train, test,
                          augment=False, log=print, mesh=mesh)
    p, s = tr.train(save_path=f"{out}/ckpt{rank}")
    result["trainer"] = {"history": tr.history, "params": p, "state": s,
                         "best_accuracy": tr.best_accuracy}
    result["refused"] = refused
    torch.save(result, f"{out}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
