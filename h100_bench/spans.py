"""The program's own spans set against the device's work, in a traced window.

The program marks its layers with ``record_function`` ranges named ``piv.*``
(``piv_liteflownet_tpu_torch/utils/profiling.py``), on the profiler's clock. This module keeps
them from a ``torch.profiler`` session, with the CUDA runtime and driver calls (host side, with
their threads and correlation ids) and each device event's correlation id, and attributes:

- a runtime call, on a thread that opens program spans, to the innermost of that thread's
  spans holding its start; on any other thread (autograd's engine thread, a library's) to the
  innermost span of the entry point's thread (the one that holds ``piv.estimate`` or
  ``piv.step``) holding its start;
- a device event to the span of the runtime call with its correlation id;
- an idle gap (:meth:`h100_bench.trace.Trace.idle_gaps`) to the innermost span of the entry
  point's thread at its midpoint, or the harness's span there where no program span holds it.

On it stand three readings a call (:func:`launches_per_call`, :func:`host_sync_ms_per_call`,
:func:`elementwise_ms_per_item`) and :meth:`Attribution.breakdown`. Every reading is None where
the trace holds no CUDA runtime call or no program span, as on the CPU or from a program
without spans.

The harness does not keep these events (``trace.from_profiler`` keeps device events and its own
spans), so its result line holds none of this: ``python3 -m h100_bench.spans`` runs a cell's
window under a profiler of every thread and prints it.

    python3 -m h100_bench.spans --workload lfn2-bf16-run-1024-b8 --seed 7 --seconds 5
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

from h100_bench.trace import CONV_KEYS, WINDOW, Trace, groups_of

PROGRAM_PREFIX = "piv."
ENTRY_SPANS = ("piv.estimate", "piv.step")
#: the spans whose own launches ``elementwise_ms`` reads: the model's subtree, ``estimate``'s
#: resizes and permute, the loss and the backward
ELEMENTWISE_SPANS = ("piv.model", "piv.NetC", "piv.pyramid", "piv.estimate.in", "piv.estimate.out",
                     "piv.step.loss", "piv.step.backward")
LEVEL_PREFIX = "piv.L"
#: runtime and driver calls that return only once the card has caught up, frozen here (names as
#: CUPTI records them); a ``cudaMemcpyAsync`` blocks too where its device copy is named pageable
BLOCKING_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaFree", "cudaFreeHost",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize", "cuMemFree_v2", "cuMemFreeHost",
})
ASYNC_COPY = ("cudaMemcpyAsync", "cuMemcpyAsync")
PAGEABLE = "pageable"
#: a CUDA runtime (``cudaLaunchKernel``) or driver (``cuLaunchKernel``) call, by name: not every
#: torch release gives a profiler event its activity type (2.11 does not)
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")
#: the kernels ATen launches itself (elementwise and vectorized loops, reductions, resizes, cat,
#: ``im2col``): what ``elementwise_ms`` counts, named so that no library kernel falls in by default
ATEN = re.compile(r"(?<![A-Za-z0-9_])at::native::")
#: a conv's kernels that :data:`CONV_KEYS` does not name: cuBLAS's GEMMs (a 1x1 conv runs as one,
#: ``nvjet_tst_...``) and cuDNN's FFT conv's pointwise product (``pointwise_mult_and_sum_complex``)
LIBRARY_CONV_KEYS = ("nvjet", "pointwise_mult_and_sum")

Span = Tuple[str, int, float, float]            # name, thread, start, end
Call = Tuple[str, int, float, float, int]       # name, thread, start, end, correlation id
Device = Tuple[str, float, float, int]          # name, start, end, correlation id


@dataclasses.dataclass
class Events:
    """What a session holds beyond :class:`Trace`: the program's spans, the runtime calls and
    the device events with their correlation ids (unclipped)."""

    spans: List[Span] = dataclasses.field(default_factory=list)
    calls: List[Call] = dataclasses.field(default_factory=list)
    device: List[Device] = dataclasses.field(default_factory=list)


def events_from_profiler(prof) -> Events:
    """The :class:`Events` of a finished ``torch.profiler.profile``. A span's or a call's thread
    is its system thread id (``device_resource_id``): ``start_thread_id`` numbers the threads
    that ran torch ops in the profiler's own sequence, which the runtime calls do not share."""
    import torch

    out = Events()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                out.device.append((name, s, t, e.correlation_id()))
        elif RUNTIME_CALL.match(name):
            out.calls.append((name, e.device_resource_id(), s, t, e.correlation_id()))
        elif name.startswith(PROGRAM_PREFIX):
            out.spans.append((name, e.device_resource_id(), s, t))
    return out


class _Timeline:
    """The innermost and the outermost span of one thread at any time, by bisection over the
    points where they change. The thread's spans nest, as ``record_function`` ranges do."""

    def __init__(self, spans: List[Tuple[str, float, float]]):
        self.at: List[float] = []
        self.names: List[Optional[Tuple[str, str]]] = []
        stack: List[Tuple[str, float, float]] = []

        def top():
            return (stack[-1][0], stack[0][0]) if stack else None

        for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
            while stack and stack[-1][2] <= s:
                end = stack.pop()[2]
                self.at.append(end)
                self.names.append(top())
            stack.append((name, s, e))
            self.at.append(s)
            self.names.append(top())
        while stack:
            end = stack.pop()[2]
            self.at.append(end)
            self.names.append(top())

    def holding(self, t: float) -> Optional[Tuple[str, str]]:
        """``(innermost, outermost)`` span names at ``t``, or None."""
        i = bisect.bisect_right(self.at, t) - 1
        return self.names[i] if i >= 0 else None


def device_class(name: str, groups: Dict[str, dict]) -> str:
    """``copy``, ``memset`` (as CUPTI names them: ``Memcpy HtoD (Pinned -> Device)``, ``Memset
    (Device)``), ``port`` (the program's kernels), ``transpose`` and ``conv`` (the library's
    convs and their layout transposes: :data:`CONV_KEYS` and :data:`LIBRARY_CONV_KEYS`),
    ``elementwise`` (ATen's own kernels, :data:`ATEN`), else ``other`` (a library kernel that
    none of these names)."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    if groups_of(name, groups):
        return "port"
    low = name.lower()
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "transpose"
    if any(k in low for k in CONV_KEYS + LIBRARY_CONV_KEYS):
        return "conv"
    if ATEN.search(name):
        return "elementwise"
    return "other"


class Attribution:
    """The spans of ``events`` set against the window of ``trace``."""

    def __init__(self, trace: Trace, events: Events):
        self.trace = trace
        self.events = events
        w0, w1 = trace.window
        by_thread: Dict[int, List[Tuple[str, float, float]]] = defaultdict(list)
        for name, tid, s, e in events.spans:
            by_thread[tid].append((name, s, e))
        self.timelines = {tid: _Timeline(spans) for tid, spans in by_thread.items()}
        entries = Counter(tid for name, tid, _, _ in events.spans if name in ENTRY_SPANS)
        self.entry_thread = entries.most_common(1)[0][0] if entries else None
        self.calls = [c for c in events.calls if w0 <= c[2] <= w1]
        self.call_span = [self.span_of_call(tid, s) for _, tid, s, _, _ in self.calls]
        by_corr = {c[4]: i for i, c in enumerate(self.calls)}
        self.device = [(n, max(s, w0), min(e, w1), corr) for n, s, e, corr in events.device if e > w0 and s < w1]
        self.device_span = [self.call_span[by_corr[corr]] if corr in by_corr else None
                            for *_, corr in self.device]
        self._copy_of = {corr: n for n, _, _, corr in events.device if n.startswith("Memcpy")}
        self._classes: Dict[str, str] = {}

    @property
    def has_spans(self) -> bool:
        return self.entry_thread is not None and bool(self.calls)

    def span_of_call(self, tid: int, t: float) -> Optional[Tuple[str, str]]:
        line = self.timelines.get(tid)
        if line is None:
            line = self.timelines.get(self.entry_thread)
        return line.holding(t) if line is not None else None

    def entry_at(self, t: float) -> Optional[str]:
        line = self.timelines.get(self.entry_thread)
        held = line.holding(t) if line is not None else None
        return held[0] if held else None

    def device_class(self, name: str) -> str:
        if name not in self._classes:
            self._classes[name] = device_class(name, self.trace.groups)
        return self._classes[name]

    # -- the readings ------------------------------------------------------------------------
    def in_entry(self, held) -> bool:
        return held is not None and held[1] in ENTRY_SPANS

    def launches(self) -> int:
        """Runtime calls in the entry point's subtree that enqueued device work: those whose
        correlation id a device event carries."""
        launched = {corr for *_, corr in self.events.device}
        return sum(1 for c, held in zip(self.calls, self.call_span) if c[4] in launched and self.in_entry(held))

    def blocking(self, call: Call) -> bool:
        name, corr = call[0], call[4]
        if name in BLOCKING_CALLS:
            return True
        return name in ASYNC_COPY and PAGEABLE in self._copy_of.get(corr, "").lower()

    def host_sync_s(self) -> float:
        """Host seconds in blocking runtime calls in the entry point's subtree."""
        return sum(c[3] - c[2] for c, held in zip(self.calls, self.call_span)
                   if self.in_entry(held) and self.blocking(c))

    def elementwise_s(self) -> float:
        """Device seconds of ATen's own kernels (:func:`device_class` ``elementwise``) launched
        from :data:`ELEMENTWISE_SPANS` or a level's module."""
        return sum(e - s for (n, s, e, _), held in zip(self.device, self.device_span)
                   if held is not None and (held[0] in ELEMENTWISE_SPANS or held[0].startswith(LEVEL_PREFIX))
                   and self.device_class(n) == "elementwise")

    def device_by_span(self) -> Dict[str, Dict[str, float]]:
        """Device seconds of each span's own launches, by :func:`device_class` and in all
        (``total``); launches in no program span under ``None``."""
        out: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        for (n, s, e, _), held in zip(self.device, self.device_span):
            row = out[held[0] if held else None]
            row[self.device_class(n)] += e - s
            row["total"] += e - s
        return {k: dict(v) for k, v in out.items()}

    def entry_self_share(self):
        """The device seconds that ``piv.estimate`` / ``piv.step`` launch outside any child span,
        over those their subtree launches; None where it launches nothing."""
        own = sub = 0.0
        for (_, s, e, _), held in zip(self.device, self.device_span):
            if self.in_entry(held):
                sub += e - s
                own += (e - s) * (held[0] in ENTRY_SPANS)
        return own / sub if sub > 0 else None

    def unattributed_busy_s(self) -> float:
        return sum(e - s for (_, s, e, _), held in zip(self.device, self.device_span) if held is None)

    def gap_name(self, s: float, e: float) -> str:
        mid = (s + e) / 2
        return self.entry_at(mid) or self.trace.host_at(mid)

    def breakdown(self, top: int = 10) -> dict:
        """``device_by_span``: the ``top`` spans whose own launches took the most device
        seconds; ``idle_gaps_by_span``: the gaps of ``Trace.breakdown``, in its order, each
        named by its program span or the harness's; ``unattributed_busy_s``."""
        spans = sorted(((k, v["total"]) for k, v in self.device_by_span().items() if k is not None),
                       key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.trace.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_by_span": [[k, v] for k, v in spans],
                "idle_gaps_by_span": [[self.gap_name(s, e), e - s] for s, e in gaps],
                "unattributed_busy_s": self.unattributed_busy_s()}


def launches_per_call(att: Attribution, stats: dict):
    """Runtime calls that enqueued device work in the entry point's subtree, a call."""
    if not att.has_spans or not stats.get("calls"):
        return None
    return att.launches() / stats["calls"]


def host_sync_ms_per_call(att: Attribution, stats: dict):
    """Host ms a call in runtime calls that wait for the card, in the entry point's subtree."""
    if not att.has_spans or not stats.get("calls"):
        return None
    return 1e3 * att.host_sync_s() / stats["calls"]


def elementwise_ms_per_item(att: Attribution, stats: dict):
    """Device ms a pair or a sample of the elementwise kernels the model, ``estimate``'s
    resizes, the loss and the backward launch."""
    if not att.has_spans or not stats.get("items"):
        return None
    return 1e3 * att.elementwise_s() / stats["items"]


READINGS = {"launches": launches_per_call, "host_sync_ms": host_sync_ms_per_call,
            "elementwise_ms": elementwise_ms_per_item}


# -- the command ------------------------------------------------------------------------------
def traced_window(workload: str, seed: int, seconds: float, device=None, overrides: Optional[dict] = None):
    """One window of ``workload`` under a profiler of every thread, set up as the harness sets up
    a cell: ``(trace, events, stats, cell)``. ``device`` None means the cell's card; tests pass
    the CPU and small ``overrides``."""
    import torch

    from h100_bench import harness
    from h100_bench.trace import from_profiler

    _, _, cell = harness.load_cell(workload, seed, device, overrides=overrides)
    if device is None:
        cell.device = harness.chip(cell.chips)
    driver = harness.load_driver(cell)
    cuda = torch.device(cell.device).type == "cuda"
    driver.setup()
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    if cuda:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, experimental_config=config) as prof:
        with torch.profiler.record_function(WINDOW):
            driver.window(seconds)
    trace, events = from_profiler(prof), events_from_profiler(prof)
    del prof
    stats = dict(driver.stats)
    driver.release()
    return trace, events, stats, cell


def report(workload: str, seed: int, seconds: float, device=None, overrides: Optional[dict] = None) -> dict:
    """One traced window of ``workload`` (:func:`traced_window`): the three readings, named as
    the cell's metrics (``launches.run``, ...), :meth:`Attribution.breakdown` as
    ``span_breakdown``, and :meth:`Attribution.entry_self_share`."""
    trace, events, stats, cell = traced_window(workload, seed, seconds, device, overrides)
    att = Attribution(trace, events)
    suffix = ".train" if cell.traffic["driver"] == "train_loop" else ".run"
    return {"workload": workload, "seed": seed, "calls": stats.get("calls"), "items": stats.get("items"),
            "busy_s": trace.busy_s(), "metrics": {name + suffix: fn(att, stats) for name, fn in READINGS.items()},
            "span_breakdown": att.breakdown(), "entry_self_share": att.entry_self_share()}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python3 -m h100_bench.spans", description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    import os
    from pathlib import Path

    import torch

    # as ``python3 -m h100_bench`` runs a cell: the same build caches, one host thread
    root = Path(__file__).resolve().parent.parent
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    torch.set_num_threads(1)
    print(json.dumps(report(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
