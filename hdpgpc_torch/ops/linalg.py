"""Jittered SPD linear algebra and Gaussian scores (counterpart of
hdpgpc_tpu.ops.linalg).

Numerical semantics follow the reference (GPI_model.py:83-113):

* ``chol_spd``: symmetrise, add ``jitter_scale * mean|diag|`` to the
  diagonal, Cholesky.
* Gaussian "squared-error" scores deliberately OMIT the log-determinant
  term (GPI_model.py:250-286, :92-113): ``-0.5 * mahalanobis -
  0.5 * T * log(2*pi)``.

Every function is batched over leading dimensions.

``chol`` is the one Cholesky of the package. It behaves like
``jnp.linalg.cholesky`` rather than ``torch.linalg.cholesky``: it
symmetrises its input (JAX's ``symmetrize_input=True``) and returns NaN
for a matrix whose factorisation fails, where torch would read only the
lower triangle and raise.

The TPU f64 workarounds of the reference (``mp64_*`` mixed-precision
solves and the QR route of ``solve_general``) are not ported: float64
is native on the card.
"""

from __future__ import annotations

import math

import torch

LOG2PI = math.log(2.0 * math.pi)


def sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def chol(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of sym(M); where the factorisation fails,
    NaN on and below the diagonal (jnp.linalg.cholesky semantics)."""
    L, info = torch.linalg.cholesky_ex(sym(M))
    bad = (info > 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L)


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B given the lower Cholesky factor L, as two
    triangular solves. (On CUDA, torch.cholesky_solve allocates and
    frees a workspace with cudaMalloc/cudaFree on every call, ~2 ms of
    host time each, measured on an H100 with torch.profiler.)"""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L^{-1} B for lower-triangular L."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def diag_mean(M: torch.Tensor) -> torch.Tensor:
    """max(mean|diag(M)|, eps) over the last two dims."""
    d = torch.diagonal(M, dim1=-2, dim2=-1).abs().mean(-1)
    return torch.clamp(d, min=torch.finfo(M.dtype).eps)


def spd_jitter(M: torch.Tensor, jitter_scale: float = 1e-8) -> torch.Tensor:
    """sym(M) plus ``jitter_scale * mean|diag|`` on the diagonal: the
    matrix ``chol_spd`` factors, for a caller that solves it with
    ops/spd_solve.spd_solve (which adds no jitter)."""
    M = sym(M)
    return M + (jitter_scale * diag_mean(M))[..., None, None] * eye_like(M)


def chol_spd(M: torch.Tensor, jitter_scale: float = 1e-8) -> torch.Tensor:
    """Cholesky of an SPD matrix with relative diagonal jitter
    (GPI_model._chol_spd, GPI_model.py:83-87)."""
    return chol(spd_jitter(M, jitter_scale))


def spd_solve(M: torch.Tensor, B: torch.Tensor,
              jitter_scale: float = 1e-8) -> torch.Tensor:
    return cho_solve(chol_spd(M, jitter_scale), B)


def gaussian_score(diff: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """-0.5 d' cov^-1 d - 0.5 T log 2pi for diff (..., T) and cov
    (..., T, T), batched over the leading dims."""
    d = diff[..., None]
    alpha = cho_solve(chol_spd(cov), d)
    return -0.5 * torch.sum(d * alpha, (-2, -1)) - 0.5 * d.shape[-2] * LOG2PI


def gaussian_score_shared_cov(Y: torch.Tensor, mean: torch.Tensor,
                              cov: torch.Tensor) -> torch.Tensor:
    """Score a batch Y (B, T) against one Gaussian (no log-det)."""
    diff = (Y - mean[None, :]).T
    alpha = cho_solve(chol_spd(cov), diff)
    return -0.5 * torch.sum(diff * alpha, dim=0) - 0.5 * diff.shape[0] * LOG2PI


def _magnitude(M: torch.Tensor) -> torch.Tensor:
    top = torch.diagonal(M, dim1=-2, dim2=-1).max(-1).values
    od = torch.floor(torch.log10(torch.clamp(
        top, min=torch.finfo(M.dtype).tiny)))
    return 10.0 ** (-od)


def logdet_spd(M: torch.Tensor) -> torch.Tensor:
    """log det via magnitude-rescaled Cholesky (GPI.log_det,
    GPI.py:1167-1198)."""
    k = _magnitude(M)
    L = chol_spd(k[..., None, None] * M, jitter_scale=0.0)
    return (2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
            - M.shape[-1] * torch.log(k))


def inv_spd(M: torch.Tensor) -> torch.Tensor:
    """Inverse via magnitude rescaling (GPI.inv_r, GPI.py:1201-1221)."""
    k = _magnitude(M)[..., None, None]
    L = chol(k * M)
    return k * cho_solve(L, eye_like(M).expand_as(M))


def solve_spd_t(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = B S^{-1} for SPD S (the reference's right-solves,
    GPI.py:145-146, :297)."""
    L = chol(sym(S))
    return cho_solve(L, B.transpose(-1, -2)).transpose(-1, -2)
