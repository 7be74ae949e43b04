"""offline.kernel_fit_s: seconds a sweep in the kernel fits (timer
kernel_fit and the batched fits inside the refit)."""

from portbench.metrics import common


def read(ctx):
    t = common.timer(ctx, "kernel_fit")
    return common.per_sweep(ctx, None if t is None
                            else t + ctx.get("kfit_prefetch_s", 0.0))
