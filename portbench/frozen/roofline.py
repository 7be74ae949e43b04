"""Roofline arithmetic, frozen copy of
hdpgpc_torch/utils/kernel_timing.py's bounds.

Peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
3.35 TB/s of device memory; 67 TFLOP/s in float32 outside the tensor
cores and 67 TFLOP/s in float64 (its tensor cores). A bound is the
least time the card could take for a call: the larger of the bytes it
must move (each input read once, each output written once) over the
memory rate, and its operations over the peak rate."""

from __future__ import annotations

from typing import Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 67e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def _bound(nbytes: float, ops: float, dtype: str) -> Tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def spd_solve_bound(n: int, T: int, R: int, dtype: str
                    ) -> Tuple[float, str]:
    """Kernel B, in ms: spd (n, T, T) and rhs (n, T, R) read, X
    (n, T, R) written; T^3/3 for the factor and 2 T^2 R for the two
    substitutions, per system."""
    size = ITEMSIZE[dtype]
    nbytes = n * (T * T + 2 * T * R) * size
    ops = n * (T ** 3 / 3.0 + 2.0 * T * T * R)
    return _bound(nbytes, ops, dtype)


def rbf_gram_bound(T1: int, T2: int, dtype: str, D: int = 1
                   ) -> Tuple[float, str]:
    """Kernel A with the noise on (T, D) grids, in ms: the grids and the
    3 parameters read, the (T1, T2) Gram written; 3 D + 3 operations an
    element plus one add per diagonal element."""
    size = ITEMSIZE[dtype]
    nbytes = ((T1 + T2) * D + 3 + T1 * T2) * size
    ops = (3.0 * D + 3.0) * T1 * T2 + min(T1, T2)
    return _bound(nbytes, ops, dtype)
