"""Arithmetic the metric readers share. Each reader is
``metrics/<metric>.py`` with ``read(ctx)``: the metric's value from
what the run recorded, or None where the run recorded nothing for it."""

from __future__ import annotations

import re
from typing import Optional

from portbench.frozen.roofline import spd_solve_bound

# the torch.linalg solves and factorisations (cuSOLVER, cuBLAS, MAGMA)
LINALG = re.compile(r"potrf|potrs|trsm|trsv|getrf|getrs|geqrf|syevj|"
                    r"cusolver|magma|cholesky|lu_factor|batch_lu",
                    re.IGNORECASE)
SPD = re.compile(r"spd_solve\[(\d+),(\d+),(\d+),(\w+)\]")


def per_sweep(ctx, value) -> Optional[float]:
    if not ctx.get("sweeps") or value is None:
        return None
    return value / ctx["sweeps"]


def timer(ctx, *names) -> Optional[float]:
    t = ctx.get("timings")
    if t is None:
        return None
    return sum(t.get(n, 0.0) for n in names)


def idle_pct(ctx) -> Optional[float]:
    s = ctx.get("slice")
    if not s or s["wall"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy"] / s["wall"])


def peak_gib(ctx) -> Optional[float]:
    b = ctx.get("peak_bytes")
    return None if not b else b / 2 ** 30


def roofline_pct(ctx) -> Optional[float]:
    """Kernel B: the least time the call sites' shapes allow (the
    frozen ``spd_solve_bound``) over the device time of the kernels
    launched inside those calls, in the profiled slice."""
    s = ctx.get("slice")
    if not s:
        return None
    bound_ms, dev_s = 0.0, 0.0
    for name, _a, _b, dev in s["spans"]:
        m = SPD.fullmatch(name)
        if m is None or dev <= 0:
            continue
        n, T, R = (int(v) for v in m.groups()[:3])
        bound_ms += spd_solve_bound(n, T, R, m.group(4))[0]
        dev_s += dev
    if dev_s <= 0:
        return None
    return 100.0 * bound_ms * 1e-3 / dev_s


def linalg_pct(ctx) -> Optional[float]:
    s = ctx.get("slice")
    if not s:
        return None
    tot = sum(s["by_name"].values())
    if tot <= 0:
        return None
    lin = sum(v for k, v in s["by_name"].items() if LINALG.search(k))
    return 100.0 * lin / tot
