"""Tracing hooks on torch.profiler (counterpart of
quantnet/bench/profiling.py:21-45): named regions around pipeline stages,
so a timeline attributes time to train, calibrate, eval and bench.

    with trace("traces/run"):
        with annotate("eval:static"):
            run_eval(...)

`trace` writes a Chrome trace (`trace.json`, host and, with a card, CUDA
activity) into the directory; open it in Perfetto or chrome://tracing.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the enclosed region into `logdir`/trace.json."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region on the profiler's timeline."""
    return record_function(name)


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str]) -> Iterator[None]:
    """trace() when a directory is given, nothing otherwise."""
    if logdir:
        with trace(logdir):
            yield
    else:
        yield
