"""f64.kernel_fit_steps: Adam steps the batched kernel fits ran a sweep
(the program's recorder counter kernel_fit.steps over the window's
sweeps); None where the program records no such counter."""

from portbench.metrics import common


def read(ctx):
    c = (ctx.get("recorder") or {}).get("counters", {})
    return common.per_sweep(ctx, c.get("kernel_fit.steps"))
