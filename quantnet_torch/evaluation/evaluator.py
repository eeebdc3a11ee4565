"""Accuracy: top-1, top-k and per-class (counterpart of
quantnet/evaluation/evaluator.py:23-174).

The metric step runs on the device as tensor ops (argmax, topk, per-class
one-hot sums, the padded rows of the last batch masked out) and its counts
stay there; the host reads them once per model, at the end.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from quantnet_torch.core.config import resolve_device
from quantnet_torch.data.datasets import Dataset


def metric_step(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                num_classes: int, top_k: int) -> torch.Tensor:
    """int64[3 + 2 * num_classes]: top-1 hits, top-k hits, valid rows, then
    correct and total per class, over the rows where `valid` is set."""
    hit1 = (logits.argmax(-1) == labels) & valid
    topk = torch.topk(logits, top_k, dim=-1).indices
    hitk = (topk == labels[:, None]).any(-1) & valid
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes) * valid[:, None]
    return torch.cat([
        torch.stack([hit1.sum(), hitk.sum(), valid.sum()]),
        (onehot * hit1[:, None]).sum(0),
        onehot.sum(0),
    ])


def _summary(counts: torch.Tensor, num_classes: int, class_names=None) -> Dict[str, object]:
    c = counts.cpu().tolist()  # the one host sync per model
    top1, topk, total = c[:3]
    correct, seen = c[3 : 3 + num_classes], c[3 + num_classes :]
    per_class = {
        (class_names[i] if class_names else i): correct[i] / seen[i]
        for i in range(num_classes) if seen[i] > 0
    }
    return {
        "top1": top1 / max(total, 1),
        "top5": topk / max(total, 1),
        "n": int(total),
        "num_classes": num_classes,
        "per_class": per_class,
    }


def _device_batches(dataset: Dataset, batch_size: int, device):
    """(images, labels, valid) on the device, the tail padded and masked."""
    n, seen = len(dataset), 0
    for images, labels in dataset.batches(batch_size, pad_remainder=True):
        bs = images.shape[0]
        n_valid = min(bs, n - seen)
        seen += n_valid
        yield (
            torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device),
            torch.arange(bs, device=device) < n_valid,
        )


class Evaluator:
    """Accumulates metrics over a Dataset with fixed-size (padded) batches.
    apply_fn(params, state, images) -> (logits, state)."""

    def __init__(
        self,
        apply_fn: Callable,
        dataset: Dataset,
        *,
        batch_size: int = 512,
        top_k: int = 5,
        class_names: Optional[Tuple[str, ...]] = None,
        device="cuda",
    ):
        self.apply_fn = apply_fn
        self.dataset = dataset
        self.batch_size = batch_size
        self.top_k = top_k
        self.class_names = class_names
        self.num_classes = dataset.num_classes
        self.device = resolve_device(device)

    @torch.no_grad()
    def evaluate(self, params: dict, state: dict) -> Dict[str, object]:
        """{'top1', 'top5', 'n', 'num_classes', 'per_class': {idx or name: acc}}."""
        counts = torch.zeros(3 + 2 * self.num_classes, dtype=torch.int64, device=self.device)
        for images, labels, valid in _device_batches(self.dataset, self.batch_size, self.device):
            logits, _ = self.apply_fn(params, state, images)
            counts += metric_step(logits, labels, valid, self.num_classes, self.top_k)
        return _summary(counts, self.num_classes, self.class_names)


def compare_models(
    models: Dict[str, Tuple[Callable, dict, dict]],
    dataset: Dataset,
    *,
    batch_size: int = 512,
    class_names: Optional[Tuple[str, ...]] = None,
    device="cuda",
) -> Dict[str, Dict[str, object]]:
    """Evaluate {name: (apply_fn, params, state)}, one pass over the data per model."""
    return {
        name: Evaluator(apply_fn, dataset, batch_size=batch_size, class_names=class_names,
                        device=device).evaluate(params, state)
        for name, (apply_fn, params, state) in models.items()
    }


@torch.no_grad()
def compare_models_single_pass(
    apply_fn: Callable,
    models: Dict[str, Tuple[dict, dict]],
    dataset: Dataset,
    *,
    batch_size: int = 512,
    top_k: int = 5,
    device="cuda",
) -> Dict[str, Dict[str, object]]:
    """Evaluate {name: (params, state)} of one model function in one pass:
    each batch goes to the device once and every model scores it there."""
    device = resolve_device(device)
    num_classes = dataset.num_classes
    counts = {name: torch.zeros(3 + 2 * num_classes, dtype=torch.int64, device=device)
              for name in models}
    for images, labels, valid in _device_batches(dataset, batch_size, device):
        for name, (params, state) in models.items():
            logits, _ = apply_fn(params, state, images)
            counts[name] += metric_step(logits, labels, valid, num_classes, top_k)
    return {name: _summary(c, num_classes) for name, c in counts.items()}
