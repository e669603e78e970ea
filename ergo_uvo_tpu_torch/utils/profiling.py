"""Tracing / profiling helpers — counterpart of ``ergo_uvo_tpu/utils/profiling.py``.

  * :func:`stage` — ``torch.profiler.record_function`` for per-stage
    attribution in profiler traces (JAX: ``jax.named_scope``);
  * :func:`trace` — a ``torch.profiler`` trace of the CPU and, where there is
    a card, CUDA around a block, written as a Chrome trace into ``logdir``
    (viewable in Perfetto or ``chrome://tracing``);
  * :class:`FrameRateCounter` — host-side frames/s (copied);
  * :func:`time_fn` — wall time per call, the card drained before each
    reading of the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def stage(name: str):
    """Named range for a pipeline stage (shows up in profiler traces)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the context into ``logdir/trace_<pid>_<ns>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class FrameRateCounter:
    """Exponential-moving-average frames/s counter."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self._last: float | None = None
        self.fps = 0.0
        self.total_frames = 0

    def tick(self, frames: int = 1) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            inst = frames / dt
            self.fps = inst if self.fps == 0 else (
                self.alpha * inst + (1 - self.alpha) * self.fps
            )
        self._last = now
        self.total_frames += frames
        return self.fps


def _drain() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, reps: int = 10, warmup: int = 1, **kw):
    """Wall-time a callable; returns seconds/rep.  The card is drained after
    the warm-up and after the timed calls, before each reading of the clock."""
    for _ in range(warmup):
        fn(*args, **kw)
    _drain()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args, **kw)
    _drain()
    return (time.perf_counter() - t0) / reps
