"""The program's kernels' share of their ops' roofline bound, in the traced window."""

from h100_bench.measure import kernels_roofline_pct


def read(run):
    return kernels_roofline_pct(run)
