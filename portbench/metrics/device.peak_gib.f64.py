"""device.peak_gib.f64: peak allocated device memory over the float64
window."""

from portbench.metrics import common


def read(ctx):
    return common.peak_gib(ctx)
