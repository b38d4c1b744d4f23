"""What the per-layer readers compute, shared by the ``.run`` and ``.train`` form of a metric.

Each function takes the :class:`h100_bench.harness.Run` of one traced run and returns a
number, or None where the run holds nothing to read.
"""

from __future__ import annotations


def per_call_ms(run, key: str):
    """Host milliseconds a call of ``stats[key]`` (seconds over the window)."""
    calls = run.stats.get("calls", 0)
    return 1e3 * run.stats[key] / calls if calls else None


def conv_ms_per_item(run):
    """Device milliseconds of the library's conv kernels a pair or a sample."""
    if run.trace is None or not run.stats.get("items"):
        return None
    secs = run.trace.conv_s()
    return 1e3 * secs / run.stats["items"] if secs > 0 else None


def kernels_roofline_pct(run):
    """The ops' bound time over the device time of the program's kernels that carry them, in
    the traced window: an op counts where a kernel of a group that carries it ran."""
    if run.trace is None:
        return None
    secs = run.trace.port_kernel_s()
    if not secs or sum(secs.values()) <= 0:
        return None
    ran = {op for g in secs for op in run.trace.groups[g]["ops"]}
    bound = sum(op.bound_s(run.elem_bytes, run.peak_flops) for op in run.work["ops_per_call"] if op.name in ran)
    return 100.0 * bound * run.stats["calls"] / sum(secs.values())


def mfu_pct(run):
    """The convs' operations of the window's completed calls over its seconds and the
    configuration's peak."""
    if not run.stats.get("calls"):
        return None
    return 100.0 * run.work["flops_per_call"] * run.stats["calls"] / run.stats["window_s"] / run.peak_flops


def idle_pct(run):
    """The share of the traced window in which nothing ran on the device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
