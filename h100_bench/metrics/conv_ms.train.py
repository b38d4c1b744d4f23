"""Device ms of the library's conv kernels (their layout transposes with them) an item."""

from h100_bench.measure import conv_ms_per_item


def read(run):
    return conv_ms_per_item(run)
