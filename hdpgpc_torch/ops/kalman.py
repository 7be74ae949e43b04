"""Kalman filter / RTS smoother primitives for the iterative GP
(counterpart of hdpgpc_tpu.ops.kalman).

Semantics mirror the reference's IterativeGaussianProcess
(GPI.py:72-151 ``posterior``, :240-300 ``backward``) on the shared grid
(the GP cross-covariance projection is the identity):

* prediction: m = A f,  P = A P A' + Gamma
* FIRST step special case: P = K, predicted obs = 0, innovation
  covariance = white-noise * I / h   (GPI.py:136-139)
* gain solved right-to-left: K = P C' (C P C' + R)^-1 (GPI.py:145-146)
* Joseph-form covariance update (GPI.py:149-150)

Every function broadcasts over leading (job) dimensions; ``first`` is a
bool tensor of the leading shape. The associative-scan parallel
filter/smoother of the reference (kalman.py:111-261) is not ported yet
(ROADMAP A3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hdpgpc_torch.ops import linalg


class LDSParams(NamedTuple):
    A: torch.Tensor       # (..., T, T)
    Gamma: torch.Tensor
    C: torch.Tensor
    Sigma: torch.Tensor


def _t(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def kalman_step(f, P, y, params: LDSParams, first, noise_first, h=1.0):
    """One filter update. f (..., T, 1), P (..., T, T), y (..., T, 1);
    ``first`` (...) bool; ``noise_first`` (...) white-noise variance for
    the first step. Returns (f_post, P_post)."""
    A, Gamma, C, Sigma = params
    eye = linalg.eye_like(P)
    fm = torch.as_tensor(first, device=P.device)[..., None, None]
    m = A @ f
    P_pred = torch.where(fm, P, A @ P @ _t(A) + Gamma)
    y_pred = torch.where(fm, torch.zeros_like(m), C @ m)
    nf = torch.as_tensor(noise_first, dtype=P.dtype, device=P.device)
    R = torch.where(fm, (nf / h)[..., None, None] * eye, Sigma / h)
    S = C @ P_pred @ _t(C) + R
    K = linalg.solve_spd_t(S, P_pred @ _t(C))
    f_post = m + K @ (y - y_pred)
    IKC = eye - K @ C
    P_post = IKC @ P_pred @ _t(IKC) + K @ R @ _t(K)
    return f_post, P_post


def rts_pair(f_prev, P_prev, f_cur, P_cur, A, Gamma):
    """One RTS step: condition (f_prev, P_prev) on (f_cur, P_cur)
    (GPI.backward_notrange, GPI.py:272-300)."""
    P_pred = A @ P_prev @ _t(A) + Gamma
    J = linalg.solve_spd_t(P_pred, P_prev @ _t(A))
    f_sm = f_prev + J @ (f_cur - A @ f_prev)
    P_sm = P_prev + J @ (P_cur - P_pred) @ _t(J)
    return f_sm, P_sm


def rts_smooth(A_seq, Gamma_seq, means, covs):
    """Full RTS backward pass with per-step parameters over the leading
    (time) axis: means (N, ..., T, 1), covs (N, ..., T, T); step t uses
    A_seq[t] (GPI.py:263-269)."""
    N = means.shape[0]
    f_out, P_out = [None] * N, [None] * N
    f_out[-1], P_out[-1] = means[-1], covs[-1]
    for t in range(N - 2, -1, -1):
        f_out[t], P_out[t] = rts_pair(means[t], covs[t], f_out[t + 1],
                                      P_out[t + 1], A_seq[t], Gamma_seq[t])
    return torch.stack(f_out), torch.stack(P_out)
