"""Data-parallel weak scaling over local devices (counterpart of
quantnet/bench/scaling.py:24-89).

For each mesh size n (1, 2, 4, ... and the device count, `mesh_sizes`) the
params are replicated onto the first n devices and each device runs the
forward on its own `per_device_batch` images: the global batch grows with
n. A window is `iters` rounds of one forward per device between CUDA
events on each device (on the CPU, which runs only when asked for, the host
clock around the same rounds); a round's time is the slowest device's,
averaged over `windows` windows. eff(n) = throughput(n) / (n * throughput(1)).
Pure data-parallel inference has no cross-device reduction, so a shortfall
from 1 is runtime overhead.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from quantnet_torch.bench.benchmark import scaling_efficiency
from quantnet_torch.parallel.mesh import local_devices, make_mesh, replicate

__all__ = ["mesh_sizes", "measure_scaling", "scaling_efficiency"]


def mesh_sizes(n_devices: int) -> Tuple[int, ...]:
    """1, 2, 4, ... up to n_devices, and n_devices itself."""
    sizes, s = [], 1
    while s <= n_devices:
        sizes.append(s)
        s *= 2
    if sizes[-1] != n_devices:
        sizes.append(n_devices)
    return tuple(sizes)


_default_sizes = mesh_sizes


def _round_ms(run_round, devices, iters: int) -> float:
    """Mean ms of one round over `iters` rounds: CUDA events on each card
    (the slowest card's time), the host clock on the CPU."""
    if devices[0].type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            run_round()
        return (time.perf_counter() - t0) * 1e3 / iters
    cards = sorted({d.index for d in devices})
    events = {i: (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for i in cards}
    for i in cards:
        events[i][0].record(torch.cuda.current_stream(i))
    for _ in range(iters):
        run_round()
    for i in cards:
        events[i][1].record(torch.cuda.current_stream(i))
    for i in cards:
        torch.cuda.synchronize(i)
    return max(s.elapsed_time(e) for s, e in events.values()) / iters


@torch.no_grad()
def measure_scaling(
    apply_fn: Callable,
    params: dict,
    state: dict,
    *,
    image_size: int = 32,
    channels: int = 3,
    per_device_batch: int = 256,
    mesh_sizes: Optional[Sequence[int]] = None,
    iters: int = 20,
    windows: int = 3,
    seed: int = 0,
    devices: Optional[Sequence] = None,
) -> Dict[str, object]:
    """{'throughput': {n: img/s}, 'efficiency': {n: eff}, 'device': name} over
    the local `devices` (default: every card)."""
    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    sizes = tuple(mesh_sizes) if mesh_sizes else _default_sizes(len(devices))
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((per_device_batch, image_size, image_size, channels), generator=g)
    throughput: Dict[int, float] = {}
    for n in sizes:
        if n > len(devices):
            continue
        mesh = make_mesh(n, devices=devices[:n])
        shards = list(zip(replicate(mesh, params), replicate(mesh, state),
                          [x.to(d) for d in mesh.devices]))

        def run_round():
            for p, s, xd in shards:
                apply_fn(p, s, xd)

        _round_ms(run_round, mesh.devices, 1)  # warm-up: kernels built, caches filled
        ms = statistics.fmean(_round_ms(run_round, mesh.devices, max(iters, 1)) for _ in range(windows))
        throughput[n] = n * per_device_batch / (ms / 1e3)
    name = "cpu" if devices[0].type == "cpu" else torch.cuda.get_device_name(devices[0])
    return {"throughput": throughput, "efficiency": scaling_efficiency(throughput), "device": name}
