"""device.idle_pct.offline: share of the profiled slice's wall time with no
device activity."""

from portbench.metrics import common


def read(ctx):
    return common.idle_pct(ctx)
