"""Host ms until the call returns, without a sync: the enqueue cost a call, over the window."""

from h100_bench.measure import per_call_ms


def read(run):
    return per_call_ms(run, "host_s")
