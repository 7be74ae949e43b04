"""offline.hdp_s: seconds a sweep in the HDP global update (timer
hdp_update)."""

from portbench.metrics import common


def read(ctx):
    return common.per_sweep(ctx, common.timer(ctx, "hdp_update"))
