"""Batched SPD factor + solve: kernel B (``csrc/spd_solve.cu``) and its
plain versions.

Counterpart of ``hdpgpc_tpu/ops/pallas/chol_solve.py``. ``spd_solve``
is the one call through which every refit step solves its stack of SPD
systems (models/gplds.py::make_forward_step). A tensor on the CPU takes
the plain version; a CUDA tensor launches the kernel, or raises. There
is no fallback between the two, and no shape the kernel refuses.

``spd_solve_plain`` (``torch.linalg``) is the CPU route of the main
path. ``spd_solve_blocked_plain`` repeats kernel B's own algorithm step
by step (panels of ``PANEL`` columns, identity padding, inverted
diagonal blocks, substitutions as block products); the tests hold it
against JAX, and the main path never calls it.

The reference's runtime gate ``pallas_solves_enabled`` (a numeric check
and a timing check against XLA) is not ported as a gate: its numeric
check is a phase of ``chip_smoke.py`` and its timing is recorded in
PERF.md.
"""

from __future__ import annotations

import torch

from hdpgpc_torch.ops import _build, linalg

# panel width of kernel B (kNB in csrc/spd_solve.cu)
PANEL = 32


def spd_solve_plain(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """X[i] = spd[i]^{-1} rhs[i] via ``linalg.chol`` (symmetrise, NaN on
    a failed factorisation) and ``linalg.cho_solve`` (two triangular
    solves)."""
    return linalg.cho_solve(linalg.chol(spd), rhs)


def spd_solve_blocked_plain(spd: torch.Tensor,
                            rhs: torch.Tensor) -> torch.Tensor:
    """Kernel B's algorithm in PyTorch, for spd (n, T, T), rhs (n, T, R).

    sym(spd) is padded to Tp (T rounded up to ``PANEL``) with an
    identity block, and factored right-looking, one panel of ``PANEL``
    columns at a time: the diagonal block column by column (pivots by
    rsqrt; the kernel does this in one warp), its inverse by forward
    substitution, the panel below as a product with that inverse, then
    the trailing lower triangle. L Y = B and L' X = Y are solved one
    block row at a time: an update from the finished rows, then a
    product with the inverted diagonal block. A non-positive or NaN
    pivot makes the whole system NaN."""
    n, T, _ = spd.shape
    R = rhs.shape[2]
    nb = PANEL
    Tp = -(-T // nb) * nb
    dt, dev = spd.dtype, spd.device
    A = torch.zeros((n, Tp, Tp), dtype=dt, device=dev)
    A[:, :T, :T] = linalg.sym(spd)
    pad = torch.arange(T, Tp, device=dev)
    A[:, pad, pad] = 1.0
    L = torch.zeros_like(A)            # the factor's off-diagonal blocks
    inv = []                           # inverted diagonal blocks
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    for k0 in range(0, Tp, nb):
        k1 = k0 + nb
        D = A[:, k0:k1, k0:k1].tril()
        rs = torch.empty((n, nb), dtype=dt, device=dev)
        for j in range(nb):
            d = D[:, j, j]
            ok &= d > 0
            rs[:, j] = torch.rsqrt(d)
            D[:, j + 1:, j] *= rs[:, j, None]
            c = D[:, j + 1:, j]
            D[:, j + 1:, j + 1:] -= (c[:, :, None] * c[:, None, :]).tril()
        Dinv = torch.zeros_like(D)
        for m in range(nb):
            Dinv[:, m, :m] = -rs[:, m, None] * (
                D[:, m, None, :m] @ Dinv[:, :m, :m])[:, 0]
            Dinv[:, m, m] = rs[:, m]
        inv.append(Dinv)
        if k1 < Tp:
            L21 = A[:, k1:, k0:k1] @ Dinv.transpose(1, 2)
            L[:, k1:, k0:k1] = L21
            A[:, k1:, k1:] -= L21 @ L21.transpose(1, 2)
    B = torch.zeros((n, Tp, R), dtype=dt, device=dev)
    B[:, :T] = rhs
    Y = torch.zeros_like(B)
    for p, k0 in enumerate(range(0, Tp, nb)):
        Rp = B[:, k0:k0 + nb] - L[:, k0:k0 + nb, :k0] @ Y[:, :k0]
        Y[:, k0:k0 + nb] = inv[p] @ Rp
    X = torch.zeros_like(B)
    for p in reversed(range(Tp // nb)):
        k0, k1 = p * nb, p * nb + nb
        Rp = Y[:, k0:k1] - L[:, k1:, k0:k1].transpose(1, 2) @ X[:, k1:]
        X[:, k0:k1] = inv[p].transpose(1, 2) @ Rp
    X = X[:, :T]
    return torch.where(ok[:, None, None], X, torch.full_like(X, float("nan")))


def spd_solve(spd: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """X[i] = spd[i]^{-1} rhs[i] for spd (n, T, T), rhs (n, T, R), any T.

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
    if n == 0 or R == 0 or T == 0:
        return out
    lib = _build.load()
    f32 = spd.dtype == torch.float32
    # where the factor does not fit in shared memory, the kernel works
    # on a copy in this scratch buffer (per system, elements)
    per = (lib.spd_solve_work_f32 if f32 else lib.spd_solve_work_f64)(T, R)
    work = torch.empty(n * per, dtype=spd.dtype, device=spd.device) \
        if per else None
    fn = lib.spd_solve_f32 if f32 else lib.spd_solve_f64
    with torch.cuda.device(spd.device):
        stream = torch.cuda.current_stream(spd.device).cuda_stream
        _build.check(fn(spd.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                        None if work is None else work.data_ptr(),
                        n, T, R, stream), "spd_solve")
    spd_solve.launches += 1
    return out


spd_solve.launches = 0
