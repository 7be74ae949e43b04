"""kernel_b.roofline_pct.stream: kernel B's share of its roofline in the
stream slice."""

from portbench.metrics import common


def read(ctx):
    return common.roofline_pct(ctx)
