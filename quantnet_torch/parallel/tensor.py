"""Tensor parallelism on the model axis (counterpart of quantnet/parallel/
mesh.py:187-240, `_spec_for_param` and `shard_params(..., model_parallel=
True)`).

The JAX package places fc1's weight split by columns (its bias along N) and
fc2's split by rows, everything else replicated, and XLA inserts the
collectives. The port has no partitioner, so the split is explicit:

  - `shard_params` leaves each rank of a model group its slice of the
    logical tree, by `spec_for_param`'s rule, and puts a `TensorShard`
    under each split layer's 'tp' key. A QTensor's payload is sliced by the
    rule, and so are the parts of its constants that run along the split
    axis: at fc1 (columns) the per-channel scale, 'wsum', the bias and BN's
    vectors (and running statistics, which follow the columns here); at
    fc2 (rows) a grouped weight's [G, N] scales and colsums along G, while
    a per-channel scale, 'wsum' and the bias stay whole and are applied
    after the reduction. Each split layer's GEMM constants are made again
    from its slice.
  - ops/linear.py runs a column shard as the whole layer on its columns
    (bit-equal to those columns of the unsharded output), and makes every
    reduction over a row shard's K global: a max by an all-reduce max, an
    int32 accumulator by an int32 all-reduce sum (both exact), an f32
    partial sum by `ordered_sum` in rank order (equal up to reassociation);
    the bias and the epilogue come once, after it.
  - Megatron's conjugate pair carries the gradients: before a column shard
    the identity forward and the model axis's sum of the input gradient
    backward (`TensorShard.enter`); after a row shard the model axis's sum
    forward and the identity backward (`TensorShard.leave`).
  - `gather_params` is the inverse of the split, for a float tree: the
    transforms (quantize, calibrate, bake) run on the gathered logical tree,
    as the JAX package's run on logical arrays, and the result is sharded.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from quantnet_torch.core.types import QTensor
from quantnet_torch.ops.linear import gemm_constants, needs_gemm_constants
from quantnet_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    all_gather,
    all_reduce,
    broadcast,
    ordered_sum,
    replicate,
)

COLUMN, ROW = "column", "row"


def spec_for_param(names: Sequence[str], ndim: int, model_parallel: bool) -> Optional[int]:
    """The axis a leaf at path `names` is split along on the model axis, or
    None (replicated): `_spec_for_param`'s rule. fc1's 2-D weight by columns
    (axis 1) and its 1-D vectors along N (axis 0); fc2's 2-D weight by rows
    (axis 0); everything else replicated."""
    if not model_parallel:
        return None
    names = [str(n) for n in names]
    if "fc1" in names:
        return {2: 1, 1: 0}.get(ndim)
    if "fc2" in names and ndim == 2:
        return 0
    return None


def shard_kind(names: Sequence[str]) -> Optional[str]:
    """The split of a layer at path `names`: fc1 column, fc2 row, else None."""
    names = [str(n) for n in names]
    return COLUMN if "fc1" in names else ROW if "fc2" in names else None


class _EnterColumns(torch.autograd.Function):
    """Before a column shard: the identity forward; the input's gradient
    summed over the model axis backward (each rank's columns contribute)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(ctx.mesh, g, MODEL_AXIS), None


class _LeaveRows(torch.autograd.Function):
    """After a row shard: the partial sums added over the model axis in rank
    order forward; the identity backward."""

    @staticmethod
    def forward(ctx, t, mesh):
        return ordered_sum(mesh, t, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """A dense layer's place on the model axis, under its 'tp' key: `kind`
    column (N split) or row (K split), the layer's global `k` and `n`, and
    the collectives ops/linear.py reduces with."""

    kind: str
    mesh: Mesh
    k: int
    n: int

    @property
    def index(self) -> int:
        return self.mesh.model_rank

    @property
    def size(self) -> int:
        return self.mesh.model_size

    @property
    def k_range(self):
        """[lo, hi) of the global K that this rank's rows hold (a row shard)."""
        step = self.k // self.size
        return self.index * step, (self.index + 1) * step

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """model_max: the all-reduce max over the model axis (exact)."""
        return model_max(self.mesh, t)

    def int_sum(self, t: torch.Tensor) -> torch.Tensor:
        """An int32 accumulator summed over the model axis (exact)."""
        return all_reduce(self.mesh, t, dist.ReduceOp.SUM, MODEL_AXIS)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1 or not (x.requires_grad and torch.is_grad_enabled()):
            return x
        return _EnterColumns.apply(x, self.mesh)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return y
        if y.requires_grad and torch.is_grad_enabled():
            return _LeaveRows.apply(y, self.mesh)
        return ordered_sum(self.mesh, y, MODEL_AXIS)


def model_max(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise max of every model rank's `t`: for a reduction over a
    K that the model axis splits (absmax), exact."""
    return all_reduce(mesh, t, dist.ReduceOp.MAX, MODEL_AXIS)


def model_broadcast(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Model index 0's `t` on every rank of its model group (a copy)."""
    if mesh.model_size == 1:
        return t
    return broadcast(mesh, t, src=mesh.rank * mesh.model_size, group=mesh.model_group)


def _take(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    size = t.shape[axis]
    if size % mesh.model_size:
        raise ValueError(f"a dimension of {size} does not split over {mesh.model_size} model ranks")
    step = size // mesh.model_size
    return t.narrow(axis, mesh.model_rank * step, step).contiguous()


def _shard_qtensor(q: QTensor, axis: Optional[int], mesh: Mesh) -> QTensor:
    """A 2-D weight's slice: the payload along `axis`, with the scale where
    it runs along that axis (a per-channel scale along N at a column shard;
    a grouped scale along N, or along G at a row shard). A packed payload is
    widened, sliced and packed again."""
    if axis is None:
        return q
    values = _take(q.int8_values(), axis, mesh)
    scale = q.scale
    if q.group_size is not None:
        if axis == 0 and values.shape[0] % q.group_size:
            raise ValueError(f"a row shard of {values.shape[0]} rows splits a group of {q.group_size}")
        scale = _take(scale, 2 if axis == 1 else 0, mesh)
    elif axis == 1 and scale.ndim == 2:
        scale = _take(scale, 1, mesh)
    if q.zero_point is not None and q.zero_point.ndim:
        raise ValueError("a weight with a per-channel zero point is not split")
    out = QTensor(values=values, scale=scale, zero_point=q.zero_point, axis=q.axis, bits=q.bits,
                  group_size=q.group_size)
    return out.packed() if q.is_packed else out


def _shard(node, names: tuple, mesh: Mesh):
    if isinstance(node, dict):
        out = {k: _shard(v, names + (str(k),), mesh) for k, v in node.items() if k != "gemm"}
        kind = shard_kind(names) if "w" in node else None
        if kind is not None:
            w = node["w"]
            out["tp"] = TensorShard(kind, mesh, w.shape[0], w.shape[-1])
        if needs_gemm_constants(out):
            out["gemm"] = gemm_constants(out)
        return out
    if isinstance(node, QTensor):
        return _shard_qtensor(node, spec_for_param(names, len(node.shape), True), mesh)
    if isinstance(node, torch.Tensor):
        axis = spec_for_param(names, node.ndim, True)
        return node if axis is None else _take(node, axis, mesh)
    return node


def split_params(mesh: Mesh, tree):
    """This rank's slice of a whole tree on the model axis, by
    spec_for_param: its split layers marked (TensorShard under 'tp') and
    their GEMM constants made from the slice."""
    if mesh.kind != "processes":
        raise ValueError("the model axis lives on a process mesh")
    return _shard(tree, (), mesh)


def shard_params(mesh: Mesh, tree, *, model_parallel: bool = False):
    """Place a params (or state) tree on a process mesh: rank 0's tree on
    every rank (`replicate`), and with model_parallel on a mesh with a model
    axis each rank's slice of it (`split_params`)."""
    tree = replicate(mesh, tree)
    if not model_parallel or mesh.model_size == 1:
        return tree
    return split_params(mesh, tree)


def _gather(node, names: tuple, mesh: Mesh):
    if isinstance(node, dict):
        return {k: _gather(v, names + (str(k),), mesh) for k, v in node.items()
                if k not in ("tp", "gemm")}
    if isinstance(node, QTensor):
        raise ValueError("gather_params takes a float tree: quantize after gathering")
    if isinstance(node, torch.Tensor):
        axis = spec_for_param(names, node.ndim, True)
        if axis is None:
            return node
        parts = all_gather(mesh, node.detach().contiguous(), MODEL_AXIS)
        return torch.cat(parts, dim=axis)
    return node


def gather_params(mesh: Mesh, tree):
    """shard_params' inverse for a float tree (params, BN state, a QAT tree
    with its FakeQuant markers): each split leaf's slices gathered over the
    model axis in rank order, the 'tp' markers dropped: the logical tree, on
    every rank alike."""
    if mesh.model_size == 1:
        return tree
    return _gather(tree, (), mesh)


def sharded_leaves(tree: dict, model_parallel: bool, names: tuple = ()) -> List[bool]:
    """Whether each tensor of a params tree is split on the model axis, in
    train/trainer.py::tensor_leaves' order (dict keys sorted)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(sharded_leaves(v, model_parallel, names + (str(k),)))
        elif isinstance(v, torch.Tensor):
            out.append(spec_for_param(names + (str(k),), v.ndim, model_parallel) is not None)
    return out


def global_norm_sq(mesh: Mesh, grads: List[torch.Tensor], split: List[bool]) -> torch.Tensor:
    """The squared global norm of gradients on a mesh with a model axis: a
    replicated leaf (the same on every rank of a model group) counted once,
    the split leaves' squares summed over the model axis in rank order."""
    zero = torch.zeros((), device=grads[0].device)
    rep = sum((torch.sum(g * g) for g, s in zip(grads, split) if not s), zero)
    part = sum((torch.sum(g * g) for g, s in zip(grads, split) if s), zero)
    return rep + ordered_sum(mesh, part.reshape(1), MODEL_AXIS)[0]
