"""Training (counterpart of quantnet/train/trainer.py): the optimizers and
schedules, on-device augmentation, the loss, the train and eval steps and
the Trainer with best-accuracy checkpoints.

Two optimizers, as the JAX package chains them from optax:
  - sgd_cosine: [global-norm clip] -> + weight_decay * p (every leaf, BN and
    biases included) -> momentum 0.9 trace -> * -schedule(count), the
    schedule cosine over all steps, after an optional linear warmup;
  - adam_plateau: [clip] -> Adam (b1 0.9, b2 0.999, eps 1e-8) -> * -lr, the
    lr halved when the test loss has not improved for more than 2 epochs.
They are written here as in-place updates of the params' tensors in optax's
formulas and order, not as torch.optim classes, whose formulas differ (the
clip's divisor, Adam's epsilon). The schedules are evaluated in f32 at the
step count before the update, as optax's jitted schedule computes them: XLA
folds `pi * count / T` into `count * f32(pi * f32(1 / T))`, and its f32 cos
is libm's cosf, which the port calls too.

A step runs inside `no_tf32()`: forward, backward and update keep f32
products f32 on the card, as the JAX package's QAT ops compute at
Precision.HIGHEST. Its randomness (augmentation, then dropout) comes from
one `torch.Generator`, seeded with cfg.seed; its streams are not JAX's
threefry ones (ROADMAP Queue 3).

The optimizer updates the Trainer's own trees in place, so the Trainer
clones the caller's trees, the best trees and the trees it returns (where
the JAX package copies them to keep donated buffers alive,
quantnet/train/trainer.py:354-357,605-607,617-623). Training checkpoints
are the port's own format (train/checkpoint.py::save); the JAX package's
orbax checkpoints are not read.

Over several processes the Trainer takes a process mesh
(parallel/mesh.py::make_mesh), as the JAX Trainer takes a mesh
(quantnet/train/trainer.py:288-347, 386-430, 505-545): rank 0's params are
broadcast; each rank keeps its contiguous, wrap-padded slice of each split
on the host and takes the JAX shard-local shuffle's rows of it every step
(parallel/steps.py); the steps are the data-parallel ones; evaluation masks
the wrap-padded rows and sums the counts across ranks. Only rank 0 logs and
writes checkpoints. Several processes without a mesh raise.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from quantnet_torch.core.config import TrainConfig, no_tf32, resolve_device
from quantnet_torch.data.datasets import Dataset

_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.cosf.restype = ctypes.c_float
_LIBM.cosf.argtypes = [ctypes.c_float]
_F32 = np.float32


def _cosf(x) -> np.float32:
    return _F32(_LIBM.cosf(float(x)))


# ---------------------------------------------------------------------------
# Schedules and optimizers (optax's formulas)
# ---------------------------------------------------------------------------


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Callable[[int], np.float32]:
    """optax.cosine_decay_schedule(init_value, decay_steps) with alpha 0,
    exponent 1, as its jitted f32 graph computes it."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs decay_steps > 0, got {decay_steps}")
    t = _F32(decay_steps)
    k = _F32(np.pi) * (_F32(1) / t)

    def schedule(count: int) -> np.float32:
        c = min(_F32(count), t)
        return _F32(init_value) * (_F32(0.5) * (_F32(1) + _cosf(c * k)))

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int
) -> Callable[[int], np.float32]:
    """optax.warmup_cosine_decay_schedule with end_value 0: a linear ramp from
    init_value to peak_value over warmup_steps, then a cosine over the rest
    of decay_steps, which counts from step 0, the warmup included."""
    w = _F32(warmup_steps)
    rw = _F32(1) / w
    span, end = _F32(init_value - peak_value), _F32(peak_value)
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)

    def schedule(count: int) -> np.float32:
        if count < warmup_steps:
            frac = _F32(1) - min(max(_F32(count), _F32(0)), w) * rw
            return span * frac + end
        return cosine(count - warmup_steps)

    return schedule


def _global_norm_clip(grads: List[torch.Tensor], max_norm: float,
                      norm_sq: Optional[Callable] = None) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g where the global norm is below max_norm,
    else (g / norm) * max_norm. Decided on the device (no host sync).
    `norm_sq(grads)` gives the squared norm where the leaves are shards of
    the model axis (parallel/tensor.py::global_norm_sq)."""
    norm = torch.sqrt(norm_sq(grads) if norm_sq is not None else sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


class Optimizer:
    """The JAX package's optimizer chain for one TrainConfig
    (quantnet/train/trainer.py:35-73) over a list of parameter tensors,
    updated in place. `init` gives the state (host count, device moments);
    `update` runs one step. `plateau` is adam_plateau's lr bookkeeping, else
    None."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int):
        self.kind = cfg.optimizer
        self.clip = cfg.grad_clip_norm if cfg.grad_clip_norm > 0 else 0.0
        self.plateau = None
        if cfg.optimizer == "sgd_cosine":
            warmup = int(cfg.warmup_epochs * steps_per_epoch)
            total = max(cfg.epochs * steps_per_epoch, 1)
            if warmup > 0:
                self.schedule = warmup_cosine_decay_schedule(
                    cfg.lr / max(warmup, 1), cfg.lr, warmup, total)
            else:
                self.schedule = cosine_decay_schedule(cfg.lr, total)
            self.momentum, self.weight_decay = cfg.momentum, cfg.weight_decay
        elif cfg.optimizer == "adam_plateau":
            self.lr = cfg.lr
            self.plateau = {"patience": 2, "factor": 0.5, "best": np.inf, "bad": 0}
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    def init(self, leaves: List[torch.Tensor]) -> dict:
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.contiguous_format)  # noqa: E731
                         for p in leaves]
        if self.kind == "sgd_cosine":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros(), "lr": float(_F32(self.lr))}

    @torch.no_grad()
    def update(self, leaves: List[torch.Tensor], grads: List[torch.Tensor], state: dict,
               norm_sq: Optional[Callable] = None) -> None:
        if self.clip:
            grads = _global_norm_clip(grads, self.clip, norm_sq)
        if self.kind == "sgd_cosine":
            step = -float(self.schedule(state["count"]))
            for p, g, t in zip(leaves, grads, state["trace"]):
                u = g + self.weight_decay * p
                t.mul_(self.momentum).add_(u)
                p.add_(t * step)
        else:
            count = state["count"] + 1
            dev = leaves[0].device
            # 1 - b ** count in f32; the moments are divided by it (a tensor
            # divisor: true division on the card too).
            bc1 = torch.tensor(_F32(1) - _F32(0.9) ** _F32(count), device=dev)
            bc2 = torch.tensor(_F32(1) - _F32(0.999) ** _F32(count), device=dev)
            step = -state["lr"]
            for p, g, m, v in zip(leaves, grads, state["mu"], state["nu"]):
                m.mul_(0.9).add_(g * (1 - 0.9))
                v.mul_(0.999).add_((g * g) * (1 - 0.999))
                p.add_((m / bc1) / (torch.sqrt(v / bc2) + 1e-8) * step)
        state["count"] += 1


# ---------------------------------------------------------------------------
# Augmentation, loss, steps
# ---------------------------------------------------------------------------


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def draw_augment(generator: torch.Generator, n: int, *, rotation_deg: float = 0.0,
                 color_jitter: float = 0.0) -> dict:
    """augment_batch's random parameters for n images, drawn from `generator`
    in this order: crop offsets ys and xs in [0, 8], flips, then the
    rotation angles in degrees and the brightness, saturation and contrast
    factors when asked for."""
    dev = generator.device
    p = {
        "ys": torch.randint(0, 9, (n,), generator=generator, device=dev),
        "xs": torch.randint(0, 9, (n,), generator=generator, device=dev),
        "flip": torch.rand(n, generator=generator, device=dev) < 0.5,
    }
    if rotation_deg:
        p["angle"] = _uniform(generator, n, -rotation_deg, rotation_deg)
    if color_jitter:
        j = color_jitter
        for key in ("brightness", "saturation", "contrast"):
            p[key] = _uniform(generator, n, 1 - j, 1 + j)
    return p


def _rotate(images: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Each image turned by its angle about its centre: the back-rotated
    grid sampled bilinearly, outside pixels 0, as
    map_coordinates(order=1, mode="constant") computes it."""
    n, h, w, c = images.shape
    dev = images.device
    rad = angle_deg * _F32(np.pi / 180)
    cos_a, sin_a = torch.cos(rad)[:, None, None], torch.sin(rad)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    sy = cos_a * (yy - cy) - sin_a * (xx - cx) + cy
    sx = sin_a * (yy - cy) + cos_a * (xx - cx) + cx

    def nodes(coord):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        return ((index, 1 - upper_w), (index + 1, upper_w))

    rows = torch.arange(n, device=dev)[:, None, None]
    out = None
    for iy, wy in nodes(sy):
        for ix, wx in nodes(sx):
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            v = images[rows, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
            term = (wy * wx)[..., None] * torch.where(valid[..., None], v, 0.0)
            out = term if out is None else out + term
    return out


def apply_augment(images: torch.Tensor, params: dict) -> torch.Tensor:
    """The train transform of quantnet/train/trainer.py:76-148 with its
    parameters given: random crop of the 4-pixel reflect-padded image,
    horizontal flip; then, where `params` holds them, rotation (bilinear,
    0 outside) and brightness, saturation and contrast jitter."""
    n, h, w, c = images.shape
    dev = images.device
    ys, xs, flip = (params[k].to(dev) for k in ("ys", "xs", "flip"))
    padded = F.pad(images.permute(0, 3, 1, 2), (4, 4, 4, 4), mode="reflect").permute(0, 2, 3, 1)
    ar_h, ar_w = torch.arange(h, device=dev), torch.arange(w, device=dev)
    rows = ys[:, None] + ar_h
    cols = xs[:, None] + torch.where(flip[:, None], w - 1 - ar_w, ar_w)
    images = padded[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    if "angle" in params:
        images = _rotate(images, params["angle"].to(dev))
    if "brightness" in params:
        b, s, cf = (params[k].to(dev)[:, None, None, None]
                    for k in ("brightness", "saturation", "contrast"))
        images = images * b
        if c == 3:
            wgt = torch.tensor([0.299, 0.587, 0.114], dtype=images.dtype, device=dev)
            lum = torch.sum(images * wgt, dim=-1, keepdim=True)
        else:
            lum = torch.mean(images, dim=-1, keepdim=True)
        images = lum + (images - lum) * s
        mean = torch.mean(images, dim=(1, 2, 3), keepdim=True)
        images = mean + (images - mean) * cf
    return images


def augment_batch(generator: torch.Generator, images: torch.Tensor, *, rotation_deg: float = 0.0,
                  color_jitter: float = 0.0) -> torch.Tensor:
    return apply_augment(images, draw_augment(generator, images.shape[0], rotation_deg=rotation_deg,
                                              color_jitter=color_jitter))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0) -> torch.Tensor:
    """-mean(sum(onehot * log_softmax(logits))), the one-hot smoothed by
    label_smoothing (quantnet/train/trainer.py:151-156)."""
    nc = logits.shape[-1]
    onehot = F.one_hot(labels.long(), nc).to(logits.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / nc
    return -torch.mean(torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1))


def tensor_leaves(tree: dict) -> List[torch.Tensor]:
    """The tree's tensors in jax.tree.leaves order (dict keys sorted)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tensor_leaves(v))
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def clone_tree(tree, device=None, requires_grad: bool = False):
    """A copy of a tree's dicts and tensors (on `device` if given), other
    leaves (a FakeQuant) shared; tensors detached, or leaves requiring grad."""
    if isinstance(tree, dict):
        return {k: clone_tree(v, device, requires_grad) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to(device or tree.device).clone()
        return t.requires_grad_(True) if requires_grad and t.is_floating_point() else t
    return tree


def train_step(apply_fn, opt: Optimizer, params, state, opt_state, leaves, generator, images, labels,
               *, label_smoothing=0.0, augment=True, rotation_deg=0.0, color_jitter=0.0):
    """One step: augment, forward in train mode, cross entropy, gradients of
    `leaves` (the params' tensors), update in place. Returns (new state, loss,
    accuracy), the last two on the device."""
    with no_tf32():
        if augment:
            images = augment_batch(generator, images, rotation_deg=rotation_deg,
                                   color_jitter=color_jitter)
        logits, new_state = apply_fn(params, state, images, train=True, generator=generator)
        loss = cross_entropy(logits, labels, label_smoothing)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # A leaf the loss does not reach has a zero gradient, as under jax.grad.
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        opt.update(leaves, grads, opt_state)
    with torch.no_grad():
        acc = (logits.argmax(-1) == labels).float().mean()
    return new_state, loss.detach(), acc


@torch.no_grad()
def eval_step(apply_fn, params, state, images, labels, valid):
    """(summed loss, top-1 hits) over the rows where `valid` is set."""
    logits, _ = apply_fn(params, state, images, train=False)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    per_example = -torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1)
    vf = valid.to(torch.float32)
    return torch.sum(per_example * vf), torch.sum((logits.argmax(-1) == labels).float() * vf)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


class Trainer:
    """Epochs, evaluation, the plateau lr and best-accuracy checkpoints
    (quantnet/train/trainer.py:228-661). Each train() draws from a generator
    on `device` seeded cfg.seed. With a `mesh` (a process mesh, or one
    device) the Trainer runs data-parallel on the mesh's device."""

    def __init__(
        self,
        apply_fn: Callable,
        params: dict,
        state: dict,
        cfg: TrainConfig,
        train_data: Dataset,
        test_data: Dataset,
        *,
        augment: bool = True,
        log: Optional[Callable[[str], None]] = print,
        device="cuda",
        mesh=None,
    ):
        from quantnet_torch.parallel import mesh as meshlib
        from quantnet_torch.parallel.steps import check_step_mesh

        self.apply_fn = apply_fn
        self.cfg = cfg
        self.train_data, self.test_data = train_data, test_data
        self.augment = augment
        self.mesh = mesh
        if mesh is None and meshlib.process_count() > 1:
            raise ValueError("several processes need a mesh (Trainer(..., mesh=make_mesh()))")
        if mesh is not None:
            check_step_mesh(mesh)
            if cfg.batch_size % mesh.size:
                raise ValueError(f"batch_size {cfg.batch_size} must divide across the data axis "
                                 f"({mesh.size})")
            device = mesh.device
            if mesh.kind == "processes":
                params, state = meshlib.replicate(mesh, params), meshlib.replicate(mesh, state)
            self._slices: dict = {}
        self.rank0 = mesh is None or mesh.rank == 0
        if log is print and not self.rank0:
            log = None  # rank 0 logs
        self.device = resolve_device(device)
        self.log = log or (lambda s: None)
        steps_per_epoch = max(len(train_data) // cfg.batch_size, 1)
        self.opt = Optimizer(cfg, steps_per_epoch)
        self.plateau = self.opt.plateau
        self._set_carry(clone_tree(params, self.device, requires_grad=True),
                        clone_tree(state, self.device), None)
        self.best_accuracy = 0.0
        self.best = None  # (params, state), detached clones
        self.history: list = []

    def _set_carry(self, params, state, opt_state):
        self.params, self.state = params, state
        self.leaves = tensor_leaves(params)
        self.opt_state = opt_state if opt_state is not None else self.opt.init(self.leaves)

    def _to_device(self, images, labels):
        return (torch.from_numpy(images).to(self.device),
                torch.from_numpy(labels).to(self.device, torch.int64))

    def _step(self, generator, images, labels):
        from quantnet_torch.parallel import steps

        cfg = self.cfg
        kw = dict(label_smoothing=cfg.label_smoothing, augment=self.augment,
                  rotation_deg=cfg.aug_rotation_deg, color_jitter=cfg.aug_color_jitter)
        args = (self.apply_fn, self.opt, self.params, self.state, self.opt_state, self.leaves,
                generator, images, labels)
        if self.mesh is None:
            self.state, loss, acc = train_step(*args, **kw)
        else:
            self.state, loss, acc = steps.train_step(self.mesh, *args, **kw)
        return loss, acc

    def _slice(self, dataset: Dataset):
        """(images, labels, rows per shard) of this rank's slice of a split,
        made once."""
        from quantnet_torch.parallel.steps import resident_rows

        key = id(dataset)
        if key not in self._slices:
            idx, rows = resident_rows(len(dataset), self.mesh.size, self.mesh.rank)
            self._slices[key] = (dataset.take(idx), dataset.labels[idx], rows)
        return self._slices[key]

    def _epoch_batches(self, epoch: int):
        """(images, labels) on the device for one training epoch: this
        rank's rows of each global batch under a mesh."""
        if self.mesh is not None:
            from quantnet_torch.parallel.steps import train_selection

            images, labels, rows = self._slice(self.train_data)
            lbs = self.cfg.batch_size // self.mesh.size
            for sel in train_selection(rows, self.mesh.size, lbs, self.cfg.seed, epoch):
                mine = sel[self.mesh.rank * lbs:(self.mesh.rank + 1) * lbs]
                yield self._to_device(images[mine], labels[mine])
            return
        for images, labels in self.train_data.batches(self.cfg.batch_size, shuffle=True,
                                                      seed=self.cfg.seed + epoch, drop_remainder=True):
            yield self._to_device(images, labels)

    def _evaluate_sharded(self) -> Tuple[float, float]:
        from quantnet_torch.parallel.steps import eval_selection, eval_step

        images, labels, rows = self._slice(self.test_data)
        lbs = self.cfg.batch_size // self.mesh.size
        r = self.mesh.rank
        total_loss = total_top1 = seen = 0.0
        for sel, valid in eval_selection(rows, self.mesh.size, lbs, len(self.test_data)):
            mine = sel[r * lbs:(r + 1) * lbs]
            x, y = self._to_device(images[mine], labels[mine])
            v = torch.from_numpy(valid[r * lbs:(r + 1) * lbs] > 0).to(self.device)
            out = eval_step(self.mesh, self.apply_fn, self.params, self.state, x, y, v)
            total_loss += out["loss_sum"]
            total_top1 += out["top1"]
            seen += out["n"]
        return total_loss / max(seen, 1), total_top1 / max(seen, 1)

    def evaluate(self) -> Tuple[float, float]:
        """(test loss, top-1) over the whole test split; the last batch is
        padded to the full batch by wrapping, its padding masked out."""
        if self.mesh is not None:
            return self._evaluate_sharded()
        total_loss = total_top1 = 0.0
        n, seen, bs = len(self.test_data), 0, self.cfg.batch_size
        for images, labels in self.test_data.batches(bs, pad_remainder=True):
            n_valid = min(images.shape[0], n - seen)
            x, y = self._to_device(images, labels)
            valid = torch.arange(x.shape[0], device=self.device) < n_valid
            loss, top1 = eval_step(self.apply_fn, self.params, self.state, x, y, valid)
            total_loss += float(loss)
            total_top1 += float(top1)
            seen += n_valid
        return total_loss / max(seen, 1), total_top1 / max(seen, 1)

    def resume(self, path: str) -> int:
        """Restore {params, state, opt_state, epoch, best_accuracy} from a
        checkpoint that save_checkpoint wrote; returns the epoch to go on from."""
        from quantnet_torch.train import checkpoint as ckpt

        tree = ckpt.restore(path, device=self.device)
        params = clone_tree(tree["params"], self.device, requires_grad=True)
        self._set_carry(params, tree["state"], tree["opt_state"])
        self.best_accuracy = float(tree["best_accuracy"])
        self.best = (clone_tree(params), clone_tree(self.state))
        return int(tree["epoch"]) + 1

    def train(self, save_path: Optional[str] = None, *, resume: bool = False,
              reload_best: bool = True) -> Tuple[dict, dict]:
        """Train cfg.epochs epochs; returns (params, state) as detached
        copies: the best test accuracy's (reload_best, the reference's
        semantics) or the last epoch's."""
        from quantnet_torch.train import checkpoint as ckpt

        cfg = self.cfg
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        start_epoch = 0
        if resume and save_path and ckpt.exists(save_path):
            start_epoch = self.resume(save_path)
            self.log(f"resumed from {save_path} at epoch {start_epoch}")
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            # Loss and accuracy stay on the device until the epoch ends.
            losses, accs = [], []
            for images, labels in self._epoch_batches(epoch):
                loss, acc = self._step(generator, images, labels)
                losses.append(loss)
                accs.append(acc)
            n_steps = len(losses)
            ep_loss = float(torch.stack(losses).sum()) if losses else 0.0
            ep_acc = float(torch.stack(accs).sum()) if accs else 0.0
            test_loss, test_acc = self.evaluate()
            self._plateau_update(test_loss)
            rec = {
                "epoch": epoch,
                "train_loss": ep_loss / max(n_steps, 1),
                "train_acc": ep_acc / max(n_steps, 1),
                "test_loss": test_loss,
                "test_acc": test_acc,
                "seconds": time.time() - t0,
            }
            self.history.append(rec)
            self.log(f"epoch {epoch}: train_loss={rec['train_loss']:.4f} "
                     f"train_acc={rec['train_acc']:.4f} test_acc={test_acc:.4f} "
                     f"({rec['seconds']:.1f}s)")
            if test_acc > self.best_accuracy:
                self.best_accuracy = test_acc
                self.best = (clone_tree(self.params), clone_tree(self.state))
                if save_path and self.rank0:
                    self.save_checkpoint(save_path, epoch)
        if reload_best and self.best is not None:
            # The optimizer's state carries over, as in the JAX package.
            self._set_carry(clone_tree(self.best[0], requires_grad=True), clone_tree(self.best[1]),
                            self.opt_state)
        return clone_tree(self.params), clone_tree(self.state)

    def _plateau_update(self, test_loss: float) -> None:
        """adam_plateau: halve the lr after more than `patience` epochs
        without a new best test loss (beyond 1e-6)."""
        p = self.plateau
        if p is None:
            return
        if test_loss < p["best"] - 1e-6:
            p["best"], p["bad"] = test_loss, 0
            return
        p["bad"] += 1
        if p["bad"] > p["patience"]:
            p["bad"] = 0
            self.opt_state["lr"] = float(_F32(self.opt_state["lr"]) * _F32(p["factor"]))

    def save_checkpoint(self, path: str, epoch: int) -> None:
        from quantnet_torch.train import checkpoint as ckpt

        ckpt.save(path, {
            "params": self.params, "state": self.state, "opt_state": self.opt_state,
            "epoch": epoch, "best_accuracy": self.best_accuracy,
        })

    def save_history(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for rec in self.history:
                f.write(json.dumps(rec) + "\n")
