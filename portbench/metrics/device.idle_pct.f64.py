"""device.idle_pct.f64: share of the float64 profiled slice's wall time
with no device activity."""

from portbench.metrics import common


def read(ctx):
    return common.idle_pct(ctx)
