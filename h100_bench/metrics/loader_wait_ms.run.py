"""Host ms a call waits on ``next()`` of the ``PrefetchLoader``: the window's total over its calls."""

from h100_bench.measure import per_call_ms


def read(run):
    return per_call_ms(run, "loader_wait_s")
