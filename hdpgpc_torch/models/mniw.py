"""Matrix-Normal-Inverse-Wishart conjugate updates for LDS parameters
(counterpart of hdpgpc_tpu.models.mniw; reference
``matrix_normal_inv_wishart``, GPI_model.py:1280-1414).

``n0`` is kept in float64 in both compute dtypes: the JAX reference
builds it from a Python float (a weakly typed float64), so its
arithmetic runs in float64 and is rounded to the compute dtype only
where it meets a matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hdpgpc_torch.ops import linalg


class MNIW(NamedTuple):
    mean: torch.Tensor     # M  (..., T, T)  matrix mean
    row_cov: torch.Tensor  # V  (..., T, T)  row covariance
    n0: torch.Tensor       # (...) dof, float64
    scale: torch.Tensor    # S  (..., T, T)


def make_mniw(mean: torch.Tensor, n0, scale: torch.Tensor) -> MNIW:
    return MNIW(mean=mean, row_cov=linalg.eye_like(mean).expand_as(mean)
                .clone(),
                n0=torch.full(mean.shape[:-2], float(n0),
                              dtype=torch.float64, device=mean.device),
                scale=scale)


def _t(M):
    return M.transpose(-1, -2)


def posterior(prior: MNIW, n_k, y1, y2, cov, cov_, cov_cross,
              sse_matrix=None) -> MNIW:
    """Conjugate update (unbatched). y1: (T, B) current states; y2:
    (T, B) regressors; cov/cov_/cov_cross: (T, T) summed state
    covariances; n_k == 1 selects the running-average form."""
    dtype = prior.scale.dtype
    eye = linalg.eye_like(prior.scale)
    if sse_matrix is None:
        sse_matrix = eye
    new_n0 = prior.n0 + n_k
    V = linalg.sym(prior.row_cov)
    jitter = 1e-2 * linalg.diag_mean(prior.scale)
    V_inv = linalg.cho_solve(linalg.chol(V + jitter * eye), eye)
    y2p = sse_matrix @ y2
    y1p = sse_matrix @ y1
    exp_f_f_ = y2p @ _t(y2p) + sse_matrix @ cov_ @ _t(sse_matrix)
    exp_ff_ = y1p @ _t(y2p) + sse_matrix @ cov_cross @ _t(sse_matrix)
    S__ = exp_f_f_ + V_inv
    S_ = exp_ff_ + prior.mean @ V_inv
    L_S = linalg.chol(linalg.sym(S__) + 1e-8 * eye)
    part_mean = _t(linalg.cho_solve(L_S, _t(S_)))
    a = (prior.n0 - 2.0).to(dtype)
    den = (new_n0 - 2.0).to(dtype)
    if int(n_k) == 1:
        new_mean = (a * prior.mean + part_mean) / den
        e = y1p - y2p
    else:
        new_mean = part_mean
        e = y1 - new_mean @ y2
    new_scale = (a * prior.scale + e @ _t(e)) / den
    return MNIW(mean=new_mean, row_cov=S__, n0=new_n0, scale=new_scale)


def log_likelihood(prior: MNIW, M, Sigma, n0=None) -> torch.Tensor:
    """Partial MNIW log-density of (M, Sigma) under ``prior``
    (GPI_model.py:1346-1362); batched over leading dims."""
    eye = linalg.eye_like(prior.scale)
    L = linalg.chol(linalg.sym(Sigma) + 1e-8 * eye)
    D = M - prior.mean
    sig_inv_D = linalg.cho_solve(L, D)
    mean_lik = -0.5 * torch.sum((D @ prior.row_cov) * sig_inv_D,
                                dim=(-2, -1))
    sig_inv_scale = linalg.cho_solve(L, prior.scale)
    scale_lik = -0.5 * torch.diagonal(sig_inv_scale, dim1=-2,
                                      dim2=-1).sum(-1)
    return mean_lik + scale_lik


def get_scale(p: MNIW, final: bool = False) -> torch.Tensor:
    """E[Sigma]-style scale (GPI_model.py:1367-1371)."""
    if final:
        return p.scale
    return p.scale * (p.n0 / (p.n0 - 2.0)).to(p.scale.dtype)[..., None,
                                                                None]
