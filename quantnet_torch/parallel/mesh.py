"""Meshes on torch.distributed (counterpart of quantnet/parallel/mesh.py:
35-100 and 213-240): the data axis, and the model axis of tensor
parallelism (parallel/tensor.py).

The JAX mesh covers every device of every process. Here a mesh is one of
two things, never both:

  - processes: the ranks of the process group, one device each. With a
    model axis of mp ranks, rank r has data index r // mp and model index
    r % mp, the layout of the JAX reshape of the devices to (dp, mp); every
    rank creates the model groups (consecutive ranks) and the data groups
    (equal model index) in the same order. Training, calibration and
    sharded evaluation run so; each data index holds its rows of a global
    batch (the ranks of a model group the same rows), and what must agree
    goes through the collectives below, over the data axis unless asked
    for the model axis.
  - local: one process over several local devices, in order: the serving
    engine and the scaling sweep, which the JAX package also runs in one
    process over `jax.devices()`, on the data axis alone. A device may
    repeat (`[cpu, cpu]` in the tests, `[cuda:0, cuda:0]` on a one-card
    machine): each entry is a shard of its own, with its own copy of the
    params. A local mesh with a model axis raises.

Backends (`init_distributed`): NCCL where each rank has a card of its own;
gloo on the CPU, and where ranks share a card (NCCL refuses two ranks on one
device). The backend chosen is printed. gloo takes CPU tensors here: a
collective of CUDA tensors over gloo goes through the host.

The collectives that must give every rank the same bits gather in rank
order and sum in that order on every rank (`ordered_sum`), so their result
does not depend on the backend's reduction algorithm; an all-reduce max or
an integer sum (`all_reduce`) is exact in any order.
"""
from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from quantnet_torch.core.config import resolve_device
from quantnet_torch.core.types import ActQuant, QTensor
from quantnet_torch.ops.linear import with_gemm_constants

DATA_AXIS = "data"
MODEL_AXIS = "model"
LOCAL_MODEL_AXIS = (
    "a local mesh has no model axis: tensor parallelism (fc1 / fc2 split over 'model') runs on "
    "a process mesh, one rank a shard (init_distributed, then make_mesh(dp, mp)); serving and "
    "the scaling sweep run on the data axis alone, as in the JAX package"
)

_rank_device: Optional[torch.device] = None
# The process groups of each (dp, mp) process mesh made so far: every rank
# makes them once, in the same order.
_groups: Dict[Tuple[int, int], Tuple[Any, Any]] = {}
# Host seconds spent in the collectives (parallel/tensor.py reads them).
collective_seconds = [0.0]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """kind "processes": `size` data indices x `model_size` model indices
    of ranks, `devices` this rank's device alone, `rank` / `model_rank` its
    indices, `data_group` / `model_group` the process groups of its axes
    (None: the world, where the other axis is 1); kind "local": `size`
    shards of one process, `devices` theirs in order."""

    kind: str
    devices: Tuple[torch.device, ...]
    size: int
    rank: int = 0
    backend: Optional[str] = None
    model_size: int = 1
    model_rank: int = 0
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size, MODEL_AXIS: self.model_size}

    @property
    def device(self) -> torch.device:
        """This rank's device (processes), or the first shard's (local)."""
        return self.devices[0]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """all_sum over the ranks: the mesh as ops/layers.py's batch axis."""
        return all_sum(self, t)


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def pick_backend(device, num_processes: int, process_id: int = 0) -> Tuple[str, torch.device]:
    """(backend, this rank's device) for `num_processes` ranks of one host on
    `device` ("cpu" or "cuda"): NCCL with card `process_id` where there are
    as many cards as ranks; gloo otherwise, ranks sharing cards round-robin."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", torch.device("cpu")
    resolve_device(device)
    cards = torch.cuda.device_count()
    if cards >= num_processes:
        return "nccl", torch.device("cuda", process_id)
    return "gloo", torch.device("cuda", process_id % cards)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    timeout_s: float = 300.0,
) -> torch.device:
    """Join the process group at `coordinator_address` (host:port or
    tcp://host:port) as rank `process_id` of `num_processes`, and return this
    rank's device. A single process joins nothing (as at
    quantnet/parallel/mesh.py:35-46) and gets `device` itself."""
    global _rank_device
    if not num_processes or num_processes <= 1:
        return resolve_device(device)
    if coordinator_address is None or process_id is None:
        raise ValueError("several processes need coordinator_address and process_id")
    backend, rank_device = pick_backend(device, num_processes, process_id)
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    if rank_device.type == "cuda":
        torch.cuda.set_device(rank_device)
    dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    why = "cards of their own" if backend == "nccl" else (
        "the CPU" if rank_device.type == "cpu" else "ranks share a card")
    print(f"init_distributed: rank {process_id} of {num_processes} on {rank_device}, backend "
          f"{backend} ({why})", flush=True)
    _rank_device = rank_device
    return rank_device


def local_devices(device="cuda") -> List[torch.device]:
    """The local devices a one-process mesh spans by default: every card,
    or the CPU (one device)."""
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(data_parallel: int = -1, model_parallel: int = 1, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data x model) mesh with the JAX validation (quantnet/parallel/
    mesh.py:50-70): -1 takes every device, a mesh larger than the devices
    raises. Under a process group of several ranks, a process mesh over all
    of them, dp x mp; else a local mesh over `devices` (default: every
    card), which takes no model axis."""
    model_parallel = max(model_parallel, 1)
    ranks = process_count()
    if ranks > 1:
        if devices is not None:
            raise ValueError("a mesh is either several processes with one device each or one "
                             "process over local devices, not both")
        if data_parallel == -1:
            data_parallel = ranks // model_parallel
        if data_parallel * model_parallel > ranks:
            raise ValueError(f"mesh {data_parallel}x{model_parallel} needs more than {ranks} ranks")
        if data_parallel * model_parallel != ranks:
            raise ValueError(f"mesh {data_parallel}x{model_parallel}: a process mesh spans all "
                             f"{ranks} ranks")
        if _rank_device is None:
            raise RuntimeError("join the process group with init_distributed")
        rank = process_index()
        data_group, model_group = _process_groups(data_parallel, model_parallel)
        return Mesh("processes", (_rank_device,), data_parallel, rank // model_parallel,
                    dist.get_backend(), model_parallel, rank % model_parallel, data_group,
                    model_group)
    if model_parallel > 1:
        raise ValueError(LOCAL_MODEL_AXIS)
    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    n = len(devices)
    if data_parallel == -1:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel > n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} needs more than {n} devices")
    return Mesh("local", tuple(devices[:data_parallel]), data_parallel)


def _process_groups(dp: int, mp: int) -> Tuple[Any, Any]:
    """(data group, model group) of this rank on a dp x mp process mesh,
    made once: every rank creates every model group (ranks d*mp .. d*mp +
    mp - 1) and then every data group (ranks j, mp + j, ...), in that order.
    Without a model axis both are None (the data axis is the world)."""
    if mp == 1:
        return None, None
    if (dp, mp) not in _groups:
        rank = process_index()
        model = [dist.new_group([d * mp + j for j in range(mp)]) for d in range(dp)]
        data = [dist.new_group([d * mp + j for d in range(dp)]) for j in range(mp)]
        _groups[(dp, mp)] = (data[rank % mp], model[rank // mp])
    return _groups[(dp, mp)]


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def map_tensors(tree, fn):
    """`tree` with fn applied to every tensor: in dicts, and in a QTensor's
    or an ActQuant's fields (their host caches dropped). Other leaves (the
    frozen markers) are shared, and a layer's GEMM constants ('gemm', a copy
    of its weight's operands) are left out. Dict keys are visited in sorted
    order, so trees built alike visit alike; the copy keeps the tree's own
    order."""
    if isinstance(tree, dict):
        done = {k: map_tensors(tree[k], fn) for k in sorted(tree, key=str) if k != "gemm"}
        return {k: done[k] for k in tree if k != "gemm"}
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, QTensor):
        zp = None if tree.zero_point is None else fn(tree.zero_point)
        return dataclasses.replace(tree, values=fn(tree.values), scale=fn(tree.scale),
                                   zero_point=zp, _nk=None)
    if isinstance(tree, ActQuant):
        return ActQuant(scale=fn(tree.scale), zero_point=fn(tree.zero_point))
    return tree


def _through_host(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type != "cpu"


def _axis(mesh: Mesh, axis: str) -> Tuple[int, Any]:
    """(ranks, process group) of one axis of a mesh."""
    if axis == DATA_AXIS:
        return mesh.size, mesh.data_group
    if axis == MODEL_AXIS:
        return mesh.model_size, mesh.model_group
    raise ValueError(f"unknown mesh axis {axis!r}")


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Global rank `src`'s tensor on every rank of `group` (default: every
    rank), a copy on t's device."""
    if mesh.kind != "processes" or mesh.size * mesh.model_size == 1:
        return t.clone()
    t0 = time.perf_counter()
    host = _through_host(mesh, t)
    buf = t.detach().cpu().clone() if host else t.detach().contiguous().clone()
    dist.broadcast(buf, src, group=group)
    out = buf.to(t.device) if host else buf
    collective_seconds[0] += time.perf_counter() - t0
    return out


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """Every rank's `t` (same shape and dtype) along one axis of the mesh,
    in rank order, on t's device."""
    n, group = _axis(mesh, axis)
    if mesh.kind != "processes" or n == 1:
        return [t]
    t0 = time.perf_counter()
    host = _through_host(mesh, t)
    src = t.detach().cpu() if host else t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    out = [o.to(t.device) for o in out] if host else out
    collective_seconds[0] += time.perf_counter() - t0
    return out


def all_reduce(mesh: Mesh, t: torch.Tensor, op, axis: str = DATA_AXIS) -> torch.Tensor:
    """`op` (dist.ReduceOp.MAX, or SUM of integers) of every rank's `t`
    along one axis: exact in any order, so the same bits on every rank."""
    n, group = _axis(mesh, axis)
    if mesh.kind != "processes" or n == 1:
        return t
    t0 = time.perf_counter()
    host = _through_host(mesh, t)
    buf = t.detach().cpu().clone() if host else t.detach().contiguous().clone()
    dist.all_reduce(buf, op=op, group=group)
    out = buf.to(t.device) if host else buf
    collective_seconds[0] += time.perf_counter() - t0
    return out


def ordered_sum(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
    """The sum of every rank's `t` along one axis, added in rank order: the
    same bits on every rank, whatever the backend."""
    parts = all_gather(mesh, t, axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class _AllSum(torch.autograd.Function):
    """ordered_sum that autograd sees: the gradient of the sum with respect
    to each rank's term is the sum of every rank's incoming gradient."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return ordered_sum(mesh, t)

    @staticmethod
    def backward(ctx, grad):
        return ordered_sum(ctx.mesh, grad), None


def all_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """ordered_sum over the data axis through which gradients flow back to
    every rank."""
    if mesh.kind != "processes" or mesh.size == 1:
        return t
    return _AllSum.apply(t, mesh)


def gather_objects(obj) -> list:
    """Every rank's picklable `obj`, in rank order (through the host); [obj]
    in one process."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def shard_batch(mesh: Mesh, batch):
    """Place a global host batch (an array or a tuple of them, the batch on
    the leading axis) on the mesh: on a process mesh the contiguous rows of
    this rank's data index (the ranks of a model group the same rows), on
    its device; on a local mesh a list of each shard's rows on its device.
    The batch must divide by the data axis's size."""

    def split(x):
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.size:
            raise ValueError(f"batch {x.shape[0]} does not divide over {mesh.size} shards")
        m = x.shape[0] // mesh.size
        if mesh.kind == "processes":
            return x[mesh.rank * m:(mesh.rank + 1) * m].to(mesh.device)
        return [x[i * m:(i + 1) * m].to(d) for i, d in enumerate(mesh.devices)]

    if isinstance(batch, (tuple, list)):
        return type(batch)(split(x) for x in batch)
    return split(batch)


def replicate(mesh: Mesh, tree):
    """The params tree on every shard (shard_params with model_parallel
    False, quantnet/parallel/mesh.py:213-240): on a process mesh rank 0's
    tree, broadcast, on this rank's device (QTensor payloads, scales and zero
    points alike; every rank passes a tree of the same structure); on a local
    mesh a list of independent copies, one per shard. Each copy's GEMM
    constants are made anew from its own tensors."""
    if mesh.kind == "processes":
        return with_gemm_constants(map_tensors(tree, lambda t: broadcast(mesh, t.to(mesh.device))))
    return [with_gemm_constants(map_tensors(tree, lambda t, d=d: t.detach().to(d, copy=True)))
            for d in mesh.devices]
