"""kernel_b.launches.offline: kernel-B launches a sweep (counter
spd_solve.launches)."""

from portbench.metrics import common


def read(ctx):
    return common.per_sweep(ctx, ctx.get("spd_launches"))
