"""The traced window: device events from ``torch.profiler``, the harness's own host spans, and
what the per-layer readers take from them.

Every time is in seconds on the profiler's clock, which it shares between the host's and the
device's events. The window is the harness's ``h100_bench.window`` range. A device event is a
kernel, a copy or a memset (not the profiler's annotation ranges), clipped to the window.
Kernels are put in groups by name: ``kernels/<group>.json`` lists the program's kernels of a
group and the ops they carry, matched as whole identifiers in the demangled name; cuDNN's
and cuBLAS's convolution kernels, their layout transposes with them, are matched by the
substrings of :data:`CONV_KEYS` after the program's own kernels.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "h100_bench.window"
SPAN_PREFIX = "h100_bench."
CONV_KEYS = ("conv", "gemm", "xmma", "cutlass", "cudnn", "implicit", "winograd", "fft", "sm90_",
             "wgrad", "dgrad", "nchwtonhwc", "nhwctonchw")
KERNELS_DIR = Path(__file__).resolve().parent / "kernels"


def kernel_groups(directory: Path = KERNELS_DIR) -> Dict[str, dict]:
    """``group -> {"ops": [...], "kernels": [...]}`` from every ``kernels/*.json``."""
    return {p.stem: json.loads(p.read_text()) for p in sorted(directory.glob("*.json"))}


def _pattern(name: str) -> re.Pattern:
    return re.compile(r"(?<![A-Za-z0-9_])" + re.escape(name) + r"(?![A-Za-z0-9_])")


def groups_of(kernel: str, groups: Dict[str, dict]) -> List[str]:
    """The program's kernel groups whose names ``kernel`` holds as a whole identifier."""
    return [g for g, spec in groups.items() if any(_pattern(k).search(kernel) for k in spec["kernels"])]


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    """``device``: ``(name, start, end)`` of each device event; ``spans``: ``(name, start,
    end)`` of each harness span; ``window``: ``(start, end)``."""

    def __init__(self, device: List[Tuple[str, float, float]], spans: List[Tuple[str, float, float]],
                 window: Tuple[float, float], groups: Optional[Dict[str, dict]] = None):
        w0, w1 = window
        self.window = window
        self.device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
        self.spans = spans
        self.groups = kernel_groups() if groups is None else groups
        self._by_name: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            self._by_name[n] += e - s
        self._group_cache: Dict[str, List[str]] = {}

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged((s, e) for _, s, e in self.device))

    def _groups(self, name: str) -> List[str]:
        if name not in self._group_cache:
            self._group_cache[name] = groups_of(name, self.groups)
        return self._group_cache[name]

    def port_kernel_s(self) -> Dict[str, float]:
        """Device seconds of each group of the program's kernels that ran."""
        out: Dict[str, float] = defaultdict(float)
        for name, secs in self._by_name.items():
            for g in self._groups(name):
                out[g] += secs
        return dict(out)

    def conv_s(self) -> float:
        """Device seconds of the library's convolution kernels (not the program's own)."""
        return sum(secs for name, secs in self._by_name.items()
                   if not self._groups(name) and any(k in name.lower() for k in CONV_KEYS))

    def idle_gaps(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window
        busy = merged((s, e) for _, s, e in self.device)
        gaps, at = [], w0
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if w1 > at:
            gaps.append((at, w1))
        return gaps

    def host_at(self, t: float) -> str:
        """The innermost harness span (other than the window) that holds time ``t``."""
        best, best_len = "outside the harness's spans", float("inf")
        for n, s, e in self.spans:
            if n != WINDOW and s <= t <= e and e - s < best_len:
                best, best_len = n[len(SPAN_PREFIX):], e - s
        return best

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self._by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self.host_at((s + e) / 2), e - s] for s, e in gaps]}


def from_profiler(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` whose body ran the window
    inside ``record_function(WINDOW)``."""
    import torch

    device, spans, window = [], [], None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((e.name(), s, t))
        elif e.name().startswith(SPAN_PREFIX):
            spans.append((e.name(), s, t))
            if e.name() == WINDOW:
                window = (s, t)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    return Trace(device, spans, window)
