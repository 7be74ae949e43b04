"""f64.kernel_fit_s: seconds a float64 sweep in the kernel fits (timer
kernel_fit and the batched fits inside the refit), as
offline.kernel_fit_s."""

from portbench.metrics import common


def read(ctx):
    t = common.timer(ctx, "kernel_fit")
    return common.per_sweep(ctx, None if t is None
                            else t + ctx.get("kfit_prefetch_s", 0.0))
