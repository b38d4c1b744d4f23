"""Profiling hooks: a ``torch.profiler`` trace and a step timer.

Port of ``piv_liteflownet_tpu/utils/profiling.py``. ``trace(logdir)`` records
the CPU and, where CUDA is available, the CUDA activity of its block and
writes a Chrome trace (``chrome://tracing``, Perfetto) into ``logdir``. Where
the JAX package printed a warning and went on when a trace could not start,
this raises: a run asked to be traced is not run untraced.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None):
    """Trace the block into ``<logdir>/trace-<time>-<pid>.json`` (nothing when ``logdir`` is
    empty). Yields the ``torch.profiler.profile``, or None; its ``trace_path`` is set on exit."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
    print(f"[profiling] trace written to {path} ({time.perf_counter() - t0:.2f}s span)")


class StepTimer:
    """Rolling per-step latency/throughput tracker for training loops (host clock)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean_s(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean_s if self.mean_s else 0.0
