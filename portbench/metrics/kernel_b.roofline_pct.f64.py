"""kernel_b.roofline_pct.f64: kernel B's float64 build against its
roofline: the frozen spd_solve_bound of each spd_solve[n,T,R,float64]
call in the profiled slice over the device time of its kernels."""

from portbench.metrics import common


def read(ctx):
    s = ctx.get("slice")
    if not s:
        return None
    f64 = [sp for sp in s["spans"] if sp[0].startswith("spd_solve[")
           and sp[0].endswith(",float64]")]
    return common.roofline_pct(dict(ctx, slice=dict(s, spans=f64)))
