"""f64.refit_slots: job slots the refit's scans ran a sweep, padding
included (the program's recorder counters refit.head_slots, the
sequential head, and refit.tail_slots, the frozen tail past the
estimation limit, over the window's sweeps); None where the program
records neither."""

from portbench.metrics import common


def read(ctx):
    c = (ctx.get("recorder") or {}).get("counters", {})
    n = [c[k] for k in ("refit.head_slots", "refit.tail_slots") if k in c]
    return common.per_sweep(ctx, sum(n) if n else None)
