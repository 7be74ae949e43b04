"""kernel_b.launches.f64: kernel-B launches a float64 sweep (counter
spd_solve.launches)."""

from portbench.metrics import common


def read(ctx):
    return common.per_sweep(ctx, ctx.get("spd_launches"))
