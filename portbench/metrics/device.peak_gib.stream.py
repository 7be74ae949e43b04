"""device.peak_gib.stream: peak allocated device memory over the window."""

from portbench.metrics import common


def read(ctx):
    return common.peak_gib(ctx)
