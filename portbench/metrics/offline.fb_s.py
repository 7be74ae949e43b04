"""offline.fb_s: seconds a sweep in the HMM messages (timer fb)."""

from portbench.metrics import common


def read(ctx):
    return common.per_sweep(ctx, common.timer(ctx, "fb"))
