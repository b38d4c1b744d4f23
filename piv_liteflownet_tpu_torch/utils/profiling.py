"""Tracing: a ``torch.profiler`` trace and the program's spans.

``trace(logdir)`` (port of ``piv_liteflownet_tpu/utils/profiling.py``) records
the CPU and, where CUDA is available, the CUDA activity of its block, on every
thread, and writes a Chrome trace (``chrome://tracing``, Perfetto) into
``logdir``. Where the JAX package printed a warning and went on when a trace
could not start, this raises: a run asked to be traced is not run untraced.

``span(name)`` marks a part of the program (``with span(ESTIMATE): ...``): a
``record_function`` range while a ``torch.profiler`` session records, on the
profiler's clock beside the device's events, and otherwise a shared no-op
context, so an untraced call pays one flag read a span. Nothing else turns the
spans on. The names are the constants below and, per pyramid level,
:func:`level_spans`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Tuple

import torch

ESTIMATE = "piv.estimate"
ESTIMATE_IN = "piv.estimate.in"
ESTIMATE_OUT = "piv.estimate.out"
STEP = "piv.step"
STEP_AUGMENT = "piv.step.augment"
STEP_LOSS = "piv.step.loss"
STEP_BACKWARD = "piv.step.backward"
STEP_ALLREDUCE = "piv.step.allreduce"
STEP_OPTIMIZER = "piv.step.optimizer"
MODEL = "piv.model"
NETC = "piv.NetC"
PYRAMID = "piv.pyramid"
LOADER_STAGE = "piv.loader.stage"
LOADER_WAIT = "piv.loader.wait"
#: the modules of a level, in the order the forward calls them
LEVEL_MODULES = ("NetC_ext", "NetE-M", "NetE-S", "NetE-R")

_OFF = contextlib.nullcontext()


def level_spans(level: int) -> Tuple[str, ...]:
    """The span names of level ``level``'s modules, in :data:`LEVEL_MODULES` order."""
    return tuple(f"piv.L{level}.{m}" for m in LEVEL_MODULES)


def span(name: str):
    """A ``torch.profiler.record_function(name)`` while a profiler records (the flag is read
    at each call), else a shared no-op context."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


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
    # every thread's ranges, the loader's producer among them (by default a session records
    # the thread that started it and the autograd threads it hands work to)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=every_thread) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
    print(f"[profiling] trace written to {path} ({time.perf_counter() - t0:.2f}s span)")
