"""Run one cell of ``BENCHMARK.json`` once: set-up, the measured window, the per-layer readers,
the check of the window's outputs against the plain reference, and the result line.

Everything a cell uses is found by name: ``BENCHMARK.json`` names its configuration and its
traffic; ``configs/<config>.json`` holds the model, the precision, the weights file and the
peak; ``traffic/<traffic>.json`` the mix and the driver (``drivers/<driver>.py``) that runs
it; ``workloads/<cell>.json`` what the check compares and each number's limit;
``metrics/<metric>.py`` the reader of each per-layer metric; ``kernels/<group>.json`` the
program's kernels and the ops they carry.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

from h100_bench.trace import WINDOW, from_profiler

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: Top-level module names that no run of the benchmark may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "piv_liteflownet_tpu")


class NoChip(RuntimeError):
    """The machine lacks the CUDA devices the cell asks for."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclass
class Cell:
    """One cell as a driver sees it."""

    name: str
    config: dict
    traffic: dict
    checks: dict
    seed: int
    device: Any
    chips: int = 1
    root: Path = ROOT

    @property
    def weights(self) -> Path:
        return self.root / self.config["weights"]


@dataclass
class Run:
    """What a per-layer reader reads: the driver's counts over the window (``stats``), the work
    of one call (``work``), the configuration and, in a traced run, the trace."""

    cell: Cell
    stats: Dict[str, float]
    work: Dict[str, Any]
    trace: Any = None

    @property
    def peak_flops(self) -> float:
        return float(self.cell.config["peak_tflops"]) * 1e12

    @property
    def elem_bytes(self) -> int:
        return 2 if self.cell.config["precision"] == "bfloat16" else 4


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_cell(workload: str, seed: int, device, root: Path = ROOT, overrides: Optional[dict] = None):
    """``(bench, entry, cell)`` of ``workload``; ``overrides`` (tests only) merge into the
    configuration's, the traffic's and the checks' dicts under those keys."""
    bench = read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    over = overrides or {}
    cell = Cell(name=workload,
                config=merge(read_json(root / conf["file"]), over.get("config")),
                traffic=merge(read_json(root / BENCH_DIR.name / "traffic" / f"{entry['traffic']}.json"),
                              over.get("traffic")),
                checks=merge(read_json(root / BENCH_DIR.name / "workloads" / f"{workload}.json"), over.get("checks")),
                seed=int(seed), device=device, chips=int(entry["chips"]), root=root)
    return bench, entry, cell


def load_driver(cell: Cell):
    """The driver that the cell's traffic names, ``drivers/<driver>.py``, made for the cell."""
    name = cell.traffic["driver"]
    return load_module(cell.root / BENCH_DIR.name / "drivers" / f"{name}.py", "h100_bench_driver_" + name).Driver(cell)


def chip(chips: int):
    """The first CUDA device, after checking that ``chips`` of them are there."""
    import torch

    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false: this benchmark runs on CUDA cards only")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"the cell asks for {chips} CUDA devices, {torch.cuda.device_count()} are present")
    return torch.device("cuda", 0)


def per_layer_metrics(bench: dict, workload: str) -> list:
    """The per-layer metrics this cell reports: those that list it, and those without a list
    whose end-to-end metric the cell reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    mine = {n for n, m in e2e.items() if "workloads" not in m or workload in m["workloads"]}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def end_to_end_metrics(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, process_age_s: float = 0.0,
             t_start: Optional[float] = None, device=None, root: Path = ROOT,
             overrides: Optional[dict] = None) -> dict:
    """One run of ``workload``; returns the result line's object. ``device`` None means the
    cell's CUDA cards, checked first (:class:`NoChip`); tests pass the CPU and small
    ``overrides``. ``process_age_s`` and ``t_start`` (``time.perf_counter`` at the process's
    first line) date the process's start for ``setup_s``."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench, entry, cell = load_cell(workload, seed, device, root, overrides)
    if device is None:
        cell.device = chip(cell.chips)
    driver = load_driver(cell)
    cuda = torch.device(cell.device).type == "cuda"
    driver.setup()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        prof = torch.profiler.profile(activities=acts)
    if cuda:
        torch.cuda.synchronize()
    with prof if prof is not None else nullcontext():
        t_window = time.perf_counter()
        with torch.profiler.record_function(WINDOW) if prof is not None else nullcontext():
            driver.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    run = Run(cell, dict(driver.stats), driver.work())
    if prof is not None:
        run.trace = from_profiler(prof)
        prof = None  # the profiler's events are many; the trace keeps what the readers need
    values = dict(driver.end_to_end(), setup_s=process_age_s + (t_window - t_start))
    metrics = {}
    if trace:
        for m in per_layer_metrics(bench, workload):
            reader = load_module(root / BENCH_DIR.name / "metrics" / f"{m['name']}.py", "h100_bench_metric_" + m["name"])
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in end_to_end_metrics(bench, workload):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    driver.release()
    readings, limits = driver.check(), cell.checks["limits"]
    if set(readings) != set(limits):
        raise RuntimeError(f"the check's numbers {sorted(readings)} and the limits {sorted(limits)} differ")
    checks = {n: {"value": float(readings[n]), "limit": float(v)} for n, v in limits.items()}
    failed = int(driver.stats["failed"])
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())  # NaN: false
    out = {"correct": correct, "attempted": int(driver.stats["attempted"]),
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(cell.device) if cuda else "cpu",
                      "count": cell.chips, "memory_peak_bytes": int(memory_peak)}}
    if run.trace is not None:
        out["device"].update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out
