"""Batched SPD factor + solve: kernel B (``csrc/spd_solve.cu``) and its
plain version.

Counterpart of ``hdpgpc_tpu/ops/pallas/chol_solve.py``. ``spd_solve``
is the one call through which every refit step solves its stack of SPD
systems (models/gplds.py::make_forward_step). A tensor on the CPU takes
the plain version; a CUDA tensor launches the kernel, or raises. There
is no fallback between the two.

The reference's runtime gate ``pallas_solves_enabled`` (a numeric check
and a timing check against XLA) is not ported as a gate: its numeric
check is a phase of ``chip_smoke.py`` and its timing is recorded in
PERF.md.
"""

from __future__ import annotations

import torch

from hdpgpc_torch.ops import _build, linalg


def spd_solve_plain(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """X[i] = spd[i]^{-1} rhs[i] via ``linalg.chol`` (symmetrise, NaN on
    a failed factorisation) and ``linalg.cho_solve`` (two triangular
    solves)."""
    return linalg.cho_solve(linalg.chol(spd), rhs)


def spd_solve(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """X[i] = spd[i]^{-1} rhs[i] for spd (n, T, T), rhs (n, T, R).

    The caller adds any jitter; nothing is added here."""
    if spd.device.type == "cpu" and rhs.device.type == "cpu":
        return spd_solve_plain(spd, rhs)
    if not (spd.is_cuda and rhs.is_cuda and spd.device == rhs.device):
        raise ValueError(f"spd_solve: tensors on {spd.device} and "
                         f"{rhs.device}; both must be on one CUDA device")
    if spd.dtype != rhs.dtype or spd.dtype not in (torch.float32,
                                                   torch.float64):
        raise TypeError(f"spd_solve: dtypes {spd.dtype}, {rhs.dtype}; "
                        "need one of float32/float64 for both")
    if spd.ndim != 3 or rhs.ndim != 3:
        raise ValueError("spd_solve: spd (n, T, T) and rhs (n, T, R)")
    n, T, T2 = spd.shape
    if T != T2 or rhs.shape[0] != n or rhs.shape[1] != T:
        raise ValueError(f"spd_solve: shapes {tuple(spd.shape)} and "
                         f"{tuple(rhs.shape)} do not match")
    if not (spd.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("spd_solve: inputs must be contiguous")
    R = rhs.shape[2]
    out = torch.empty_like(rhs)
    if n == 0 or R == 0:
        return out
    lib = _build.load()
    if T > lib.spd_solve_max_t():
        raise ValueError(f"spd_solve: T = {T} > {lib.spd_solve_max_t()}, "
                         "which the kernel does not take")
    fn = lib.spd_solve_f32 if spd.dtype == torch.float32 \
        else lib.spd_solve_f64
    with torch.cuda.device(spd.device):
        stream = torch.cuda.current_stream(spd.device).cuda_stream
        _build.check(fn(spd.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                        n, T, R, stream), "spd_solve")
    spd_solve.launches += 1
    return out


spd_solve.launches = 0
