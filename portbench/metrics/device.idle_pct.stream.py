"""device.idle_pct.stream: share of the profiled chunk's wall time with no
device activity."""

from portbench.metrics import common


def read(ctx):
    return common.idle_pct(ctx)
