"""linalg.device_pct.f64: share of the float64 profiled slice's device
time in the torch.linalg solves and factorisations, by kernel name."""

from portbench.metrics import common


def read(ctx):
    return common.linalg_pct(ctx)
