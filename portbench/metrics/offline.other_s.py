"""offline.other_s: seconds a sweep outside the refit, the HMM messages,
the HDP update and the kernel fits (the profiler's own start and stop
taken out)."""

from portbench.metrics import common


def read(ctx):
    t = common.timer(ctx, "refit_batch", "refit_one", "fb", "hdp_update",
                     "kernel_fit")
    return common.per_sweep(ctx, None if t is None else ctx["window_s"]
                            - ctx.get("trace_overhead_s", 0.0) - t)
