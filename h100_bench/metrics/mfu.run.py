"""The whole step's share of the configuration's peak: the convs' operations of the window's work."""

from h100_bench.measure import mfu_pct


def read(run):
    return mfu_pct(run)
