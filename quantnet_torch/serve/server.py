"""Continuous-batching inference engine (counterpart of
quantnet/serve/server.py:50-313).

Callers submit single images at any time; a dispatcher thread coalesces
whatever is queued into the smallest batch bucket that holds it (the largest
at most), and one program per bucket serves everything:

  - bucketed static batch shapes; pad rows are zeros, computed and dropped;
  - the dispatcher drains everything already queued at once, then waits out
    the head request's `max_wait_ms` for stragglers below the largest bucket;
  - dispatch and completion are decoupled: the dispatcher issues batch N and
    goes on assembling N + 1 while a completion thread waits for N's logits,
    with at most 2 batches in flight;
  - the uint8 wire (`wire_dtype="uint8"`, `normalize=(mean, std)`): requests
    are raw u8 HWC images, normalized on the device inside the program as the
    jitted JAX engine computes `(x / 255 - mean) / std`: XLA multiplies by
    f32(1 / 255) and by f32(1 / std), and so does the port;
  - an exception in a batch goes to each of its waiters, and serving goes on.

On the card the program of a bucket is a CUDA graph (`torch.cuda.CUDAGraph`),
the counterpart of the JAX engine's jitted, precompiled program per bucket:
`warmup` runs each bucket once eagerly (which builds the kernels, makes their
shared-memory opt-ins and fills every cached host scalar, so that nothing
reads the device while the forward is captured), then captures the forward,
normalization included, reading a static input buffer and writing a static
output. With `precompile=False` a bucket is captured at its first use. A
capture or replay that fails raises; the engine never carries on eagerly on
the card, nor on the CPU.

A graph's output buffer is written again by the next replay of its bucket,
so with two batches in flight each batch has a slot: a pinned host buffer
its request batch goes up from, a pinned host buffer its logits come down
to (a non-blocking copy on the engine's stream right after the replay), and
an event recorded after that copy. The completion thread waits on the event,
copies the logits out and only then hands the slot back: no staging buffer
is reused before its copies have completed.

A kernel wrapper counts a launch where Python calls it, capture included; a
replay launches what the capture recorded without calling Python, so the
wrappers' counts do not see it. A replay's kernels are counted in a device
trace (quantnet_torch/bench/trace.py).

On the CPU (`device="cpu"`, the tests) the engine runs the forward eagerly,
the kernels' plain versions, with the same threads. Data-parallel serving
over several cards (the JAX engine's `mesh`) comes with the `parallel` slice
(ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from quantnet_torch.core.config import resolve_device
from quantnet_torch.core.quantize import _mul_reciprocal

INFLIGHT = 2
_WIRE_DTYPES = {"float32": torch.float32, "uint8": torch.uint8}


class BucketGraph:
    """One bucket's captured forward: static input, graph, static output."""

    def __init__(self, forward: Callable, static_in: torch.Tensor, stream: torch.cuda.Stream):
        self.static_in = static_in
        with torch.cuda.stream(stream):
            forward(static_in)  # eager: kernels built, host scalars cached
        stream.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the completion thread may wait on an event meanwhile.
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            self.static_out = forward(static_in)

    def replay(self):
        self.graph.replay()


class _Slot:
    """Pinned host buffers of one in-flight batch on the card, and the event
    recorded after its logits were copied down."""

    def __init__(self, shape, dtype: torch.dtype):
        self.host_in = torch.zeros(shape, dtype=dtype, pin_memory=True)
        self.host_out: Optional[torch.Tensor] = None
        self.done = torch.cuda.Event()


class InferenceEngine:
    """Continuous-batching server over one program per bucket.

    apply_fn(params, state, x) -> (logits, state); params / state may be any
    fp32 or quantized tree of the port on `device`.
    """

    def __init__(
        self,
        apply_fn: Callable,
        params: dict,
        state: dict,
        *,
        image_shape: Tuple[int, int, int] = (32, 32, 3),
        buckets: Sequence[int] = (1, 8, 32, 128),
        max_wait_ms: float = 2.0,
        precompile: bool = True,
        device="cuda",
        wire_dtype: str = "float32",
        normalize: Optional[Tuple] = None,
    ):
        """wire_dtype="uint8" takes raw u8 HWC requests, normalized on the
        device with `normalize` = (mean, std) per channel, the training
        pipeline's statistics (Dataset.mean / std)."""
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.params = params
        self.state = state
        self.image_shape = tuple(image_shape)
        self.buckets = tuple(sorted(buckets))
        self.max_wait_s = max_wait_ms / 1e3
        if wire_dtype not in _WIRE_DTYPES:
            raise ValueError(f"unsupported wire_dtype {wire_dtype!r}")
        if wire_dtype == "uint8" and normalize is None:
            raise ValueError(
                "wire_dtype='uint8' needs normalize=(mean, std): the u8 payload "
                "is normalized on the device"
            )
        self.wire_dtype = np.dtype(wire_dtype)
        self._wire_torch = _WIRE_DTYPES[wire_dtype]
        self._mean = self._inv_std = None
        if wire_dtype == "uint8":
            mean = torch.as_tensor(np.asarray(normalize[0], np.float32))
            std = torch.as_tensor(np.asarray(normalize[1], np.float32))
            self._mean = mean.to(self.device)
            self._inv_std = (torch.ones_like(std) / std).to(self.device)  # f32(1 / std)
        self._cuda = self.device.type == "cuda"
        self._graphs: Dict[int, BucketGraph] = {}
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._free: "queue.Queue[_Slot]" = queue.Queue()
            for _ in range(INFLIGHT + 1):
                self._free.put(_Slot((self.buckets[-1], *self.image_shape), self._wire_torch))
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, float] = {"requests": 0, "batches": 0, "padded_rows": 0}
        # Per-request submit -> logits latencies (s), a bounded window.
        self._latencies: "collections.deque[float]" = collections.deque(maxlen=16384)
        self._inflight: "queue.Queue" = queue.Queue(maxsize=INFLIGHT)
        if precompile:
            self.warmup()
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()
        self._completion = threading.Thread(target=self._completion_loop, daemon=True)
        self._completion.start()

    # -- the program of a bucket ---------------------------------------------

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The eager forward of one batch on the engine's device, in the
        wire dtype: what a bucket's graph captures."""
        if self._mean is not None:
            x = (_mul_reciprocal(x.float(), 255.0) - self._mean) * self._inv_std
        return self.apply_fn(self.params, self.state, x)[0]

    def _graph(self, b: int) -> BucketGraph:
        g = self._graphs.get(b)
        if g is None:
            with torch.cuda.device(self.device):
                static_in = torch.zeros((b, *self.image_shape), dtype=self._wire_torch, device=self.device)
                g = BucketGraph(self.forward, static_in, self._stream)
            self._graphs[b] = g
        return g

    # -- public API -------------------------------------------------------

    def submit(self, image: np.ndarray) -> "Future[np.ndarray]":
        """Enqueue one image; resolves to its logits vector. The payload must
        have the engine's wire dtype: a cast would corrupt it (floats cut to
        0-255 codes, or u8 codes read as normalized floats)."""
        image = np.asarray(image)
        if tuple(image.shape) != self.image_shape:
            raise ValueError(f"expected {self.image_shape}, got {image.shape}")
        if image.dtype != self.wire_dtype:
            raise TypeError(f"engine wire dtype is {self.wire_dtype}, got {image.dtype}")
        fut: Future = Future()
        self._queue.put((image, fut, time.perf_counter()))
        return fut

    def predict(self, image: np.ndarray, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking single-request convenience wrapper."""
        return self.submit(image).result(timeout=timeout)

    def warmup(self):
        """Make every bucket's program: capture its graph on the card, run it
        once on the CPU."""
        for b in self.buckets:
            if self._cuda:
                self._graph(b)
            else:
                self.forward(torch.zeros((b, *self.image_shape), dtype=self._wire_torch))

    def replay(self, x: torch.Tensor) -> torch.Tensor:
        """One device batch of a bucket's size through that bucket's graph,
        synchronously; a copy of its logits. For holding a replay against
        `forward` of the same batch."""
        g = self._graph(x.shape[0])
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            g.static_in.copy_(x)
            g.replay()
            out = g.static_out.clone()
        self._stream.synchronize()
        return out

    def reset_stats(self):
        """Clear the counters and the latency window (between load phases)."""
        with self._stats_lock:
            self.stats = {k: 0 for k in self.stats}
            self._latencies.clear()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        # Batches still in flight resolve before the completion thread ends.
        try:
            self._inflight.put(None, timeout=10)
        except queue.Full:
            pass
        self._completion.join(timeout=10)

    def latency_stats(self) -> Dict[str, float]:
        """Per-request latency percentiles (ms) over the recent window,
        submit -> logits on the host."""
        with self._stats_lock:
            lat = sorted(self._latencies)
        if not lat:
            return {}
        n = len(lat)

        def pct(p: float) -> float:
            return lat[min(int(p * n), n - 1)] * 1e3

        return {"n": n, "mean_ms": sum(lat) / n * 1e3, "p50_ms": pct(0.50),
                "p95_ms": pct(0.95), "p99_ms": pct(0.99)}

    def occupancy(self) -> float:
        """Mean fraction of batch rows that carried real requests."""
        with self._stats_lock:
            served, padded = self.stats["requests"], self.stats["padded_rows"]
        total = served + padded
        return served / total if total else 1.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher --------------------------------------------------------

    def _pick_bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _dispatch_loop(self):
        pending = []
        while not self._stop.is_set():
            if not pending:
                try:
                    pending.append(self._queue.get(timeout=0.05))
                except queue.Empty:
                    continue
            # Eager drain: requests that piled up during the previous batch
            # join this one whatever their deadline.
            while len(pending) < self.buckets[-1]:
                try:
                    pending.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            # Below the largest bucket: wait out the head request's window.
            deadline = pending[0][2] + self.max_wait_s
            while len(pending) < self.buckets[-1]:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    pending.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            take = min(len(pending), self.buckets[-1])
            batch, pending = pending[:take], pending[take:]
            self._run_batch(batch)

    def _run_batch(self, batch):
        """Issue one batch and hand it to the completion thread; returns once
        the work is queued on the card (at once on the CPU's eager run)."""
        n = len(batch)
        b = self._pick_bucket(n)
        slot = self._free.get() if self._cuda else None
        try:
            if self._cuda:
                item = self._issue(slot, batch, b)
            else:
                x = np.zeros((b, *self.image_shape), self.wire_dtype)
                for i, (img, _, _) in enumerate(batch):
                    x[i] = img
                item = (None, self.forward(torch.from_numpy(x)).numpy(), batch, b)
        except Exception as e:  # every waiter gets it; serving goes on
            if slot is not None:
                self._free.put(slot)
            for _, fut, _ in batch:
                fut.set_exception(e)
            return
        self._inflight.put(item)  # blocks while INFLIGHT batches are out

    def _issue(self, slot: _Slot, batch, b: int):
        g = self._graph(b)
        host_in = slot.host_in.numpy()
        for i, (img, _, _) in enumerate(batch):
            host_in[i] = img
        host_in[len(batch):b] = 0
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            g.static_in.copy_(slot.host_in[:b], non_blocking=True)
            g.replay()
            out = g.static_out
            if slot.host_out is None:
                slot.host_out = torch.empty((self.buckets[-1], *out.shape[1:]), dtype=out.dtype,
                                            pin_memory=True)
            slot.host_out[:b].copy_(out, non_blocking=True)
            slot.done.record(self._stream)
        return (slot, None, batch, b)

    def _completion_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                return
            slot, logits, batch, b = item
            try:
                if slot is not None:
                    slot.done.synchronize()
                    logits = slot.host_out[: len(batch)].numpy().copy()
            except Exception as e:
                for _, fut, _ in batch:
                    fut.set_exception(e)
                continue
            finally:
                if slot is not None:
                    self._free.put(slot)
            done = time.perf_counter()
            # Counted before the waiters wake, so a caller reads them current.
            with self._stats_lock:
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["padded_rows"] += b - len(batch)
                for _, _, t_submit in batch:
                    self._latencies.append(done - t_submit)
            for i, (_, fut, _) in enumerate(batch):
                fut.set_result(logits[i])
