"""f64.refit_s: seconds a float64 sweep in the cluster refit (timers
refit_batch and refit_one, less the batched kernel fits they run), as
offline.refit_s."""

from portbench.metrics import common


def read(ctx):
    t = common.timer(ctx, "refit_batch", "refit_one")
    return common.per_sweep(ctx, None if t is None
                            else t - ctx.get("kfit_prefetch_s", 0.0))
