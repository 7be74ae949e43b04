"""kernel_b.roofline_pct.offline: kernel B's share of its roofline in the
offline slice."""

from portbench.metrics import common


def read(ctx):
    return common.roofline_pct(ctx)
