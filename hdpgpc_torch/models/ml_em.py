"""Maximum-likelihood EM updates for LDS parameters, the non-Bayesian
path (counterpart of hdpgpc_tpu.models.ml_em).

The reference's ML machinery (used when bayesian_params=False): the
closed-form M-step from smoothed moments (GPI.new_params_LDS,
GPI.py:302-455), the joint LDS log-likelihood that gates acceptance
(GPI.log_likelihood, GPI.py:879-974), and the iterate-until-convergence
wrapper with divergence guards (GPI_model.new_params,
GPI_model.py:747-861) plus the reestimation cadence of
new_params_weighted (GPI_model.py:874-887).

Inputs are tensors of one cluster: ys / means (N, T, 1), covs (N, T, T),
(A, Gamma, C, Sigma) (T, T); the per-step solves broadcast over the N
steps (where the reference vmaps). The solves are ``torch.linalg``, as
they were XLA in the reference; the filter/smoother that feeds the EM is
the refit (models/gplds.py::build_refit), which solves through kernel B.
The wrappers ``ml_update`` / ``ml_update_masked`` return tensors on the
inputs' device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from hdpgpc_torch.ops import linalg
from hdpgpc_torch.ops.kalman import rts_smooth

_LOG2PI = math.log(2.0 * math.pi)


def _t(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


class EMStats(NamedTuple):
    exp_tt: torch.Tensor      # (N, T, T)  E[f_t f_t']
    exp_t_t1: torch.Tensor    # (N-1, T, T) E[f_{t+1} f_t']
    exp_t1_t: torch.Tensor    # (N-1, T, T) E[f_t f_{t+1}']


def _moments(A, Gamma, means, covs) -> EMStats:
    """Smoothed second moments (GPI.py:329-346)."""
    P_pred = A @ covs @ _t(A) + Gamma
    J = linalg.solve_spd_t(P_pred, covs @ _t(A))
    exp_tt = covs + means @ _t(means)
    exp_t_t1 = covs[1:] @ _t(J[:-1]) + means[1:] @ _t(means[:-1])
    exp_t1_t = J[:-1] @ covs[1:] + means[:-1] @ _t(means[1:])
    return EMStats(exp_tt, exp_t_t1, exp_t1_t)


def m_step_dynamic(A, Gamma, C, Sigma, ys, means, covs):
    """One closed-form M-step (GPI.py:390-450 'dynamic').

    ys/means: (N, T, 1); covs: (N, T, T). Returns (A', Gamma', C',
    Sigma') with the reference's symmetrisation and 1e-8 jitters on
    near-singular accumulators (a constant jitter, as hdpgpc_tpu has it).
    """
    N = ys.shape[0]
    eye = linalg.eye_like(A)
    st = _moments(A, Gamma, means, covs)

    A1 = torch.sum(st.exp_t_t1, dim=0)
    A2 = torch.sum(st.exp_tt[:-1], dim=0)
    C1 = torch.sum(ys @ _t(means), dim=0)
    C2 = torch.sum(st.exp_tt, dim=0)

    A2 = A2 + 1e-8 * eye
    C2 = C2 + 1e-8 * eye
    A_new = linalg.solve_spd_t(A2, A1)
    C_new = linalg.solve_spd_t(C2, C1)

    G_acc = torch.sum(
        st.exp_tt[1:]
        - A_new[None] @ st.exp_t1_t
        - st.exp_t_t1 @ A_new.T[None]
        + A_new[None] @ st.exp_tt[:-1] @ A_new.T[None], dim=0)
    Gamma_new = G_acc / max(N - 1, 1)
    Gamma_new = linalg.sym(Gamma_new) + 1e-8 * eye

    S_acc = torch.sum(
        ys @ _t(ys)
        - C_new[None] @ means @ _t(ys)
        - ys @ _t(means) @ C_new.T[None]
        + C_new[None] @ st.exp_tt @ C_new.T[None], dim=0)
    Sigma_new = linalg.sym(S_acc / N) + 1e-8 * eye
    return A_new, Gamma_new, C_new, Sigma_new


def m_step_static(ys, means, covs):
    """Static model: only Sigma re-estimated (GPI.py:369-388)."""
    N = ys.shape[0]
    exp_tt = covs + means @ _t(means)
    S_acc = torch.sum(ys @ _t(ys) - means @ _t(ys) - ys @ _t(means)
                      + exp_tt, dim=0)
    return linalg.sym(S_acc / N) + 1e-8 * linalg.eye_like(covs)


def joint_log_likelihood(A, Gamma, C, Sigma, ys, means, covs):
    """Joint LDS log-likelihood over latent transitions + emissions
    (GPI.log_likelihood, GPI.py:879-974 with the t0=0 term dropped; the
    constant GP marginal does not affect the EM accept test). The
    transition term carries C where A belongs, as the reference's does
    (GPI.py:947-950)."""
    T = means.shape[1]
    N = ys.shape[0]
    exp_tt = covs + means @ _t(means)

    detG = linalg.logdet_spd(Gamma)
    Ginv = linalg.inv_spd(Gamma)
    m_next = means[1:]
    m_prev = means[:-1]
    s1 = (-torch.einsum("nij,jk,nik->", m_next, Ginv, m_next)
          + 2.0 * torch.einsum("nij,jk,kl,nil->", m_next, Ginv, C, m_prev)
          - torch.einsum("ji,jk,kl,nli->", C, Ginv, C,
                         torch.sum(exp_tt[:-1], dim=0)[None])
          - (N - 1) * detG)
    s1 = 0.5 * (s1 - (N - 1) * T * _LOG2PI)

    detS = linalg.logdet_spd(Sigma)
    Sinv = linalg.inv_spd(Sigma)
    s2 = (-torch.einsum("nij,jk,nik->", ys, Sinv, ys)
          + 2.0 * torch.einsum("nij,jk,kl,nil->", ys, Sinv, C, means)
          - torch.einsum("ji,jk,kl,nli->", C, Sinv, C,
                         torch.sum(exp_tt, dim=0)[None])
          - N * detS)
    s2 = 0.5 * (s2 - N * T * _LOG2PI)
    return s1 + s2


def _accepts(lik, lik_best, verbose) -> bool:
    """The divergence guards of GPI_model.py:796-833: reject a
    non-finite or decreasing likelihood."""
    if not bool(torch.isfinite(lik)) or float(lik) < float(lik_best):
        if verbose:
            print("Divergence detected, using previous.")
        return False
    return True


def _as_tensors(like, *arrs):
    return [torch.as_tensor(a, dtype=like.dtype, device=like.device)
            for a in arrs]


def ml_update(A, Gamma, C, Sigma, ys, means, covs, model_type="dynamic",
              max_trials: int = 6, verbose: bool = False
              ) -> Tuple[torch.Tensor, ...]:
    """Iterated EM with the reference's divergence guards
    (GPI_model.new_params, GPI_model.py:784-833): accept only
    non-decreasing, finite likelihood; re-smooth between iterations.
    As in hdpgpc_tpu, the convergence test compares the accepted
    likelihood with itself, so the loop ends after the first accepted
    M-step."""
    ys, means, covs, A_b, G_b, C_b, S_b = _as_tensors(
        torch.as_tensor(means), ys, means, covs, A, Gamma, C, Sigma)
    lik_best = joint_log_likelihood(A_b, G_b, C_b, S_b, ys, means, covs)
    A_c, G_c, C_c, S_c = A_b, G_b, C_b, S_b
    for _ in range(max_trials):
        if model_type == "static":
            S_n = m_step_static(ys, means, covs)
            A_n, G_n, C_n = A_c, G_c, C_c
        else:
            A_n, G_n, C_n, S_n = m_step_dynamic(A_c, G_c, C_c, S_c, ys,
                                                means, covs)
        N = means.shape[0]
        means, covs = rts_smooth(A_n.expand(N, *A_n.shape),
                                 G_n.expand(N, *G_n.shape), means, covs)
        lik = joint_log_likelihood(A_n, G_n, C_n, S_n, ys, means, covs)
        if not _accepts(lik, lik_best, verbose):
            break
        lik_best = lik
        A_b, G_b, C_b, S_b = A_n, G_n, C_n, S_n
        A_c, G_c, C_c, S_c = A_n, G_n, C_n, S_n
        if bool(torch.isclose(lik, lik_best, rtol=0.01)):
            break
    return A_b, G_b, C_b, S_b


# ---------------------------------------------------------------------------
# Masked (fixed-shape) variants: operate on member-gathered, tail-padded
# slot buffers (w[t] in {0,1}, contiguous ones at the front).
# ---------------------------------------------------------------------------

def m_step_dynamic_masked(A, Gamma, C, Sigma, ys, means, covs, w):
    """Masked closed-form M-step. ``w``: (N,) 0/1 slot validity,
    contiguous ones at the front (member-gathered order), so the valid
    transition pairs are exactly the slots with w[t+1] == 1."""
    eye = linalg.eye_like(A)
    n = torch.sum(w)
    w3 = w[:, None, None]
    wp = w[1:, None, None]                      # pair weights

    st = _moments(A, Gamma, means, covs)
    A1 = torch.sum(wp * st.exp_t_t1, dim=0)
    A2 = torch.sum(wp * st.exp_tt[:-1], dim=0)
    C1 = torch.sum(w3 * (ys @ _t(means)), dim=0)
    C2 = torch.sum(w3 * st.exp_tt, dim=0)

    A2 = A2 + 1e-8 * eye
    C2 = C2 + 1e-8 * eye
    A_new = linalg.solve_spd_t(A2, A1)
    C_new = linalg.solve_spd_t(C2, C1)

    G_acc = torch.sum(wp * (
        st.exp_tt[1:]
        - A_new[None] @ st.exp_t1_t
        - st.exp_t_t1 @ A_new.T[None]
        + A_new[None] @ st.exp_tt[:-1] @ A_new.T[None]), dim=0)
    Gamma_new = G_acc / torch.clamp(n - 1, min=1)
    Gamma_new = linalg.sym(Gamma_new) + 1e-8 * eye

    S_acc = torch.sum(w3 * (
        ys @ _t(ys)
        - C_new[None] @ means @ _t(ys)
        - ys @ _t(means) @ C_new.T[None]
        + C_new[None] @ st.exp_tt @ C_new.T[None]), dim=0)
    Sigma_new = linalg.sym(S_acc / torch.clamp(n, min=1)) + 1e-8 * eye
    return A_new, Gamma_new, C_new, Sigma_new


def joint_log_likelihood_masked(A, Gamma, C, Sigma, ys, means, covs, w):
    """Masked joint LDS log-likelihood (transition + emission terms)."""
    T = means.shape[1]
    n = torch.sum(w)
    exp_tt = covs + means @ _t(means)
    wp = w[1:]

    detG = linalg.logdet_spd(Gamma)
    Ginv = linalg.inv_spd(Gamma)
    m_next = means[1:]
    m_prev = means[:-1]
    s1 = (-torch.einsum("n,nij,jk,nik->", wp, m_next, Ginv, m_next)
          + 2.0 * torch.einsum("n,nij,jk,kl,nil->", wp, m_next, Ginv, C,
                               m_prev)
          - torch.einsum("ji,jk,kl,li->", C, Ginv, C,
                         torch.sum(wp[:, None, None] * exp_tt[:-1], dim=0))
          - (n - 1) * detG)
    s1 = 0.5 * (s1 - (n - 1) * T * _LOG2PI)

    detS = linalg.logdet_spd(Sigma)
    Sinv = linalg.inv_spd(Sigma)
    s2 = (-torch.einsum("n,nij,jk,nik->", w, ys, Sinv, ys)
          + 2.0 * torch.einsum("n,nij,jk,kl,nil->", w, ys, Sinv, C, means)
          - torch.einsum("ji,jk,kl,li->", C, Sinv, C,
                         torch.sum(w[:, None, None] * exp_tt, dim=0))
          - n * detS)
    s2 = 0.5 * (s2 - n * T * _LOG2PI)
    return s1 + s2


def masked_rts(A, Gamma, means, covs, w):
    """RTS smoother over member-gathered slots; padded tail slots
    (w == 0) are pass-throughs, so the backward recursion starts at the
    last REAL member. The gains do not depend on the recursion and are
    solved for every slot at once; ``w`` is read on the host once, so
    the loop does work only at member slots."""
    P_pred = A @ covs @ _t(A) + Gamma
    J = linalg.solve_spd_t(P_pred, covs @ _t(A))
    Af = A @ means
    member = (w > 0.5).tolist()
    f_out = list(means.unbind(0))
    P_out = list(covs.unbind(0))
    f_next = P_next = None
    started = False
    for t in reversed(range(means.shape[0])):
        if started:
            f_out[t] = means[t] + J[t] @ (f_next - Af[t])
            P_out[t] = covs[t] + J[t] @ (P_next - P_pred[t]) @ _t(J[t])
        if member[t]:
            f_next, P_next = f_out[t], P_out[t]
            started = True
    return torch.stack(f_out), torch.stack(P_out)


def ml_update_masked(A, Gamma, C, Sigma, ys, means, covs, w,
                     model_type="dynamic", max_trials: int = 6,
                     verbose: bool = False):
    """Masked, fixed-shape version of ``ml_update``; the same
    accept/guard semantics (GPI_model.py:784-833)."""
    ys, means, covs, w, A_b, G_b, C_b, S_b = _as_tensors(
        torch.as_tensor(means), ys, means, covs, w, A, Gamma, C, Sigma)
    lik_best = joint_log_likelihood_masked(A_b, G_b, C_b, S_b, ys, means,
                                           covs, w)
    A_c, G_c, C_c, S_c = A_b, G_b, C_b, S_b
    for _ in range(max_trials):
        if model_type == "static":
            S_n = m_step_static(ys, means, covs)
            A_n, G_n, C_n = A_c, G_c, C_c
        else:
            A_n, G_n, C_n, S_n = m_step_dynamic_masked(
                A_c, G_c, C_c, S_c, ys, means, covs, w)
        means, covs = masked_rts(A_n, G_n, means, covs, w)
        lik = joint_log_likelihood_masked(A_n, G_n, C_n, S_n, ys, means,
                                          covs, w)
        if not _accepts(lik, lik_best, verbose):
            break
        lik_best = lik
        A_b, G_b, C_b, S_b = A_n, G_n, C_n, S_n
        A_c, G_c, C_c, S_c = A_n, G_n, C_n, S_n
        if bool(torch.isclose(lik, lik_best, rtol=0.01)):
            break
    return A_b, G_b, C_b, S_b


def reestimate_cadence(n_included: int, min_samples: int = 1,
                       max_samples: int = 6, div_samples: int = 15) -> bool:
    """new_params_weighted cadence: refit in the early window or every
    div_samples (10 past 500 samples) (GPI_model.py:874-887)."""
    if n_included > 500:
        div_samples = 10
    return (min_samples < n_included < max_samples
            or (n_included % div_samples == 0 and n_included != 0))
