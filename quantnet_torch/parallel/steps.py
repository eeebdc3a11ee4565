"""Data-parallel train and eval steps over a process mesh (counterpart of
quantnet/parallel/steps.py:24-67 and 199-212), and the row selections of
the resident-split variants (:70-196, quantnet/parallel/mesh.py:102-184,
quantnet/train/trainer.py:505-545).

Each rank holds its equal share of a global batch. The train step equals
the port's one-process step (train/trainer.py::train_step) on the global
batch, as the JAX pjit step equals its single-device step:

  - train-mode BN takes the global batch's mean and variance, summed across
    ranks by an all-reduce that autograd sees (ops/layers.py::sharded_batch);
  - the gradients are averaged across ranks (summed in rank order, halved
    for two), so every rank applies the same update to the same params;
  - augmentation and dropout are drawn at the global batch's shape from a
    generator seeded alike on every rank, each rank taking its rows: the
    ranks together draw what one process draws.

The eval step sums top-1 and top-5 hits, valid rows and the loss of the
valid rows across ranks: the counts exactly.

On a dp x mp mesh (parallel/tensor.py) the data-axis sums above (BN's
statistics, the gradient average, the loss, the eval counts) run over the
data group alone: the ranks of a model group hold the same rows, and each
row is counted once. A replicated leaf's gradient is model index 0's on
every rank of a model group (broadcast over the model axis: on the CPU the
ranks compute the same bits, since the model axis's sums are ordered, but a
card's conv backward need not), so the replicated leaves stay bit-identical;
where the optimizer clips by global norm, a split leaf's squares are summed
over the model axis and a replicated leaf is counted once.

The JAX package selects each step's rows from a device-resident split with
a shard-local shuffle. The port has no resident split: each rank keeps its
contiguous, wrap-padded slice of the split on the host (`resident_rows`)
and takes the same local rows (`train_selection`, `eval_selection`).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from quantnet_torch.core.config import no_tf32
from quantnet_torch.ops.layers import sharded_batch
from quantnet_torch.parallel.mesh import Mesh, ordered_sum
from quantnet_torch.parallel.tensor import global_norm_sq, model_broadcast, sharded_leaves


def check_step_mesh(mesh: Mesh) -> None:
    """The steps run one device a process: a process mesh, or one device."""
    if mesh.kind != "processes" and mesh.size != 1:
        raise ValueError(f"the data-parallel steps take one device a process; a local mesh of "
                         f"{mesh.size} devices is for serving and the scaling sweep")


def train_step(mesh: Mesh, apply_fn: Callable, opt, params, state, opt_state, leaves, generator,
               images, labels, *, label_smoothing=0.0, augment=True, rotation_deg=0.0,
               color_jitter=0.0):
    """One data-parallel step on this rank's rows `images` / `labels` of
    the global batch: augment, forward in train mode, cross entropy,
    gradients averaged across ranks, update in place. Returns (new state,
    loss, accuracy), the last two the global batch's, on the device."""
    from quantnet_torch.train.trainer import apply_augment, cross_entropy, draw_augment

    check_step_mesh(mesh)
    m = images.shape[0]
    rows = slice(mesh.rank * m, (mesh.rank + 1) * m)
    with no_tf32(), sharded_batch(mesh):
        if augment:
            drawn = draw_augment(generator, m * mesh.size, rotation_deg=rotation_deg,
                                 color_jitter=color_jitter)
            images = apply_augment(images, {k: v[rows] for k, v in drawn.items()})
        logits, new_state = apply_fn(params, state, images, train=True, generator=generator)
        loss = cross_entropy(logits, labels, label_smoothing)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # A leaf the loss does not reach has a zero gradient, as under jax.grad.
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        if mesh.size > 1:
            flat = ordered_sum(mesh, torch.cat([g.reshape(-1) for g in grads])) / mesh.size
            grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
        norm_sq = None
        if mesh.model_size > 1:
            split = sharded_leaves(params, True)
            if len(split) != len(leaves):
                raise ValueError("on a model axis the step takes leaves = tensor_leaves(params)")
            # A replicated leaf is one logical weight: every rank of a model
            # group applies model index 0's gradient (a card's backward, a
            # conv's weight gradient by atomics, need not give two ranks the
            # same bits for the same inputs).
            rep = [i for i, sp in enumerate(split) if not sp]
            flat = model_broadcast(mesh, torch.cat([grads[i].reshape(-1) for i in rep]))
            for i, f in zip(rep, flat.split([grads[i].numel() for i in rep])):
                grads[i] = f.view_as(grads[i])
            norm_sq = functools.partial(global_norm_sq, mesh, split=split)
        opt.update(leaves, grads, opt_state, norm_sq)
    with torch.no_grad():
        acc = (logits.argmax(-1) == labels).float().mean()
        both = ordered_sum(mesh, torch.stack([loss.detach(), acc])) / mesh.size
    return new_state, both[0], both[1]


@torch.no_grad()
def eval_step(mesh: Mesh, apply_fn: Callable, params, state, images, labels, valid=None,
              *, top_k: int = 5) -> Dict[str, float]:
    """{'loss_sum', 'top1', 'top5', 'n'} over the global batch whose rows
    this rank holds, counted where `valid` is set (every row without it):
    the hits and rows exactly, the loss summed in rank order."""
    check_step_mesh(mesh)
    logits, _ = apply_fn(params, state, images)
    if valid is None:
        valid = torch.ones(labels.shape[0], dtype=torch.bool, device=labels.device)
    vf = valid.to(torch.float32)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    loss_sum = torch.sum(-torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1) * vf)
    top1 = ((logits.argmax(-1) == labels) & valid).sum()
    topk = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).indices
    top5 = ((topk == labels[:, None]).any(-1) & valid).sum()
    counts = ordered_sum(mesh, torch.stack([top1, top5, valid.sum()]))
    loss = ordered_sum(mesh, loss_sum.reshape(1))
    c = counts.tolist()
    return {"loss_sum": float(loss[0]), "top1": c[0], "top5": c[1], "n": c[2]}


# ---------------------------------------------------------------------------
# Row selection over a rank's slice of the split
# ---------------------------------------------------------------------------


def resident_rows(n: int, ndata: int, shard: int) -> Tuple[np.ndarray, int]:
    """(dataset indices of shard `shard`'s rows, rows per shard): the split
    padded by wrapping to a multiple of `ndata`, cut into contiguous blocks
    (quantnet/parallel/mesh.py:102-184)."""
    rows = -(-n // ndata)
    return np.arange(shard * rows, (shard + 1) * rows) % n, rows


def train_selection(rows: int, ndata: int, lbs: int, seed: int, epoch: int) -> List[np.ndarray]:
    """The epoch's index vectors, one per step: int32[ndata * lbs], shard d's
    local rows in block d, from the shard-local shuffle
    default_rng((seed + epoch) * 100003 + d).permutation(rows), resized to
    steps * lbs (quantnet/train/trainer.py:518-536)."""
    steps = max(rows // lbs, 1)
    perms = [np.resize(np.random.default_rng((seed + epoch) * 100003 + d).permutation(rows),
                       steps * lbs) for d in range(ndata)]
    return [np.concatenate([p[s * lbs:(s + 1) * lbs] for p in perms]).astype(np.int32)
            for s in range(steps)]


def eval_selection(rows: int, ndata: int, lbs: int, n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(int32 local rows, f32 valid), each [ndata * lbs], per eval batch: the
    shards' rows in order, padded by wrapping; a row past a shard's end or
    a wrapped copy of the split's start masked out
    (quantnet/train/trainer.py:416-430)."""
    out = []
    for start in range(0, rows, lbs):
        local = (start + np.arange(lbs)) % rows
        in_range = (start + np.arange(lbs)) < rows
        sel = np.tile(local, ndata).astype(np.int32)
        valid = np.concatenate([in_range & ((d * rows + local) < n) for d in range(ndata)])
        out.append((sel, valid.astype(np.float32)))
    return out
