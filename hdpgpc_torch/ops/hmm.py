"""HMM message passing over the beat sequence (counterpart of
hdpgpc_tpu.ops.hmm).

Mirrors the reference's forward/backward/coupled-pair computations on
log evidence (GPI_HDP.py:3546-3699), including its flooring constants:

* forward: PiTMat[PiTMat < 1e-6] += 1e-4, pi[pi < 1e-10] += 1e-4
  (GPI_HDP.py:3584-3585)
* backward: PiMat[PiMat < 1e-5] += 1e-4 and row normalisation by the
  sum over all-but-last entries (GPI_HDP.py:3643-3646)
* responsibilities are HARD one-hot argmax assignments (first maximum,
  ``_safe_exp``, GPI_HDP.py:338-350), not softmax.

The forward and backward messages are associative scans of normalised
matrix products (``ops.scan``), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from hdpgpc_torch.ops.scan import associative_scan


def row_normalize_log(logw: torch.Tensor, axis: int = 1):
    """Subtract the row max (reference LogLik, GPI_HDP.py:632-661)."""
    c = torch.amax(logw, dim=axis, keepdim=True)
    return logw - c, c.squeeze(axis)


def _safe_exp_rows(x: torch.Tensor) -> torch.Tensor:
    """exp(x - rowmax) with NaN -> 1e-8 (reference local safe_exp)."""
    m = torch.amax(x, dim=1, keepdim=True)
    return torch.nan_to_num(torch.exp(x - m), nan=1e-8)


def hard_resp(logresp: torch.Tensor) -> torch.Tensor:
    """Hard one-hot row argmax (GPI_HDP.py:338-343)."""
    idx = torch.argmax(logresp, dim=-1)
    return torch.nn.functional.one_hot(
        idx, logresp.shape[-1]).to(logresp.dtype)


def hard_resp_pair(logrespPair: torch.Tensor) -> torch.Tensor:
    """Hard one-hot over flattened (K, K) per row (GPI_HDP.py:344-350)."""
    N, K, _ = logrespPair.shape
    idx = torch.argmax(logrespPair.reshape(N, K * K), dim=-1)
    return torch.nn.functional.one_hot(idx, K * K).to(
        logrespPair.dtype).reshape(N, K, K)


def _norm_compose(a, b):
    """Normalised matrix composition (``b`` later): the product is
    divided by its total mass, which every downstream use cancels."""
    c = b @ a
    s = torch.sum(c, dim=(-2, -1), keepdim=True)
    return c / torch.where(s == 0, torch.ones_like(s), s)


def _floor(M: torch.Tensor, below: float) -> torch.Tensor:
    return torch.where(M < below, M + 1e-4, M)


def forward(start_log_pi, trans_log_pi, log_q):
    """Normalised forward filtering. start_log_pi (K,), trans_log_pi
    (K, K), log_q (N, K) row-normalised log evidence. Returns fmsg (N, K)
    and margPrObs (N,)."""
    pi = _floor(torch.exp(start_log_pi), 1e-10)
    PiT = _floor(_safe_exp_rows(trans_log_pi.T), 1e-6)
    q = _safe_exp_rows(log_q)
    N = q.shape[0]
    a1 = pi * q[0]
    marg1 = torch.sum(a1)
    f1 = a1 / marg1
    if N == 1:
        return f1[None], marg1[None]
    M = q[1:, :, None] * PiT[None]              # diag(q_t) PiT
    C = associative_scan(_norm_compose, M)
    alpha = C @ f1
    fmsg = torch.cat([f1[None], alpha / torch.sum(alpha, 1, keepdim=True)])
    # marg_t on the NORMALISED previous message (GPI_HDP.py:3595-3601)
    marg_rest = torch.sum(torch.einsum("tij,tj->ti", M, fmsg[:-1]), 1)
    return fmsg, torch.cat([marg1[None], marg_rest])


def forward_seq(start_log_pi, trans_log_pi, log_q):
    """The sequential reference recursion (GPI_HDP.py:3546-3610 as
    written), the oracle for ``forward``."""
    pi = _floor(torch.exp(start_log_pi), 1e-10)
    PiT = _floor(_safe_exp_rows(trans_log_pi.T), 1e-6)
    q = _safe_exp_rows(log_q)
    fs, margs = [], []
    for t in range(q.shape[0]):
        f = pi * q[t] if t == 0 else (PiT @ fs[-1]) * q[t]
        marg = torch.sum(f)
        fs.append(f / marg)
        margs.append(marg)
    return torch.stack(fs), torch.stack(margs)


def forward_incremental(fmsg_prev, trans_log_pi, log_q_last):
    """Append one forward step to a cached fmsg (GPI_HDP.py:3586-3594)."""
    PiT = _floor(_safe_exp_rows(trans_log_pi.T), 1e-6)
    q_last = torch.nan_to_num(torch.exp(log_q_last - torch.max(log_q_last)),
                              nan=1e-8)
    f = (PiT @ fmsg_prev) * q_last
    marg = torch.sum(f)
    return f / marg, marg


def backward(trans_log_pi, log_q):
    """Backward messages with the reference's quirky normalisation:
    bmsg[t] = PiMat @ (bmsg[t+1] * q[t+1]) divided by the sum of its
    entries EXCLUDING the last column (GPI_HDP.py:3644-3646)."""
    PiMat = _floor(_safe_exp_rows(trans_log_pi), 1e-5)
    q = _safe_exp_rows(log_q)
    N, K = q.shape
    b_last = torch.ones(K, dtype=q.dtype, device=q.device)
    if N == 1:
        return b_last[None]
    Bm = PiMat[None] * q[1:, None, :]            # PiMat diag(q)
    C = associative_scan(_norm_compose, Bm, reverse=True)
    b = torch.sum(C, dim=2)
    b = b / torch.sum(b[:, :-1], dim=1, keepdim=True)
    return torch.cat([b, b_last[None]])


def backward_seq(trans_log_pi, log_q):
    """The sequential reference recursion (GPI_HDP.py:3612-3649 as
    written), the oracle for ``backward``."""
    PiMat = _floor(_safe_exp_rows(trans_log_pi), 1e-5)
    q = _safe_exp_rows(log_q)
    N, K = q.shape
    bs = [torch.ones(K, dtype=q.dtype, device=q.device)]
    for t in range(N - 2, -1, -1):
        b = PiMat @ (bs[0] * q[t + 1])
        bs.insert(0, b / torch.sum(b[:-1]))
    return torch.stack(bs)


def coupled_pair_log(alpha, beta, trans_log_pi, log_q):
    """log respPair (N, K, K), reference coupled_state_coef
    (GPI_HDP.py:3651-3699)."""
    PiMat = _safe_exp_rows(trans_log_pi)
    bmsgSoftEv = _safe_exp_rows(log_q) * beta
    N, K = alpha.shape
    respPair = torch.zeros((N, K, K), dtype=alpha.dtype, device=alpha.device)
    respPair[1:] = alpha[:-1][:, :, None] * bmsgSoftEv[1:][:, None, :]
    respPair = respPair * PiMat[None]
    den = torch.sum(respPair, dim=(1, 2))[:, None, None]
    den = torch.where(den == 0, torch.full_like(den, 1e-10), den)
    return torch.log(respPair / den)


def _fb_messages(start_log_pi, trans_log_pi, log_q):
    """Shared FB core: returns (logresp, logrespPair)."""
    q_norm, _ = row_normalize_log(log_q, axis=1)
    alpha, _marg = forward(start_log_pi, trans_log_pi, q_norm)
    beta = backward(trans_log_pi, q_norm)
    logresp, _ = row_normalize_log(torch.log(alpha * beta), axis=1)
    lrp = coupled_pair_log(alpha, beta, trans_log_pi, q_norm)
    # the reference's LogLik(axis=1) isinf early-return always fires
    # (row 0 is log 0): the raw globally-normalised pair tensor is used
    c = torch.amax(lrp, dim=1, keepdim=True)
    logrespPair = torch.where(torch.any(torch.isinf(c)), lrp, lrp - c)
    return logresp, logrespPair


def fb_hard(start_log_pi, trans_log_pi, log_q):
    """normalise q -> FB -> hard resp and respPair. Returns (resp,
    logresp, respPair, logrespPair) (variational_local_terms contract)."""
    logresp, logrespPair = _fb_messages(start_log_pi, trans_log_pi, log_q)
    return (hard_resp(logresp), logresp, hard_resp_pair(logrespPair),
            logrespPair)


def fb_hard_packed(packed):
    """fb_hard on one packed tensor: row 0 = start_log_pi, rows [1, Kp]
    = trans_log_pi, rows [Kp+1, ...) = log_q."""
    Kp = packed.shape[1]
    return fb_hard(packed[0], packed[1:Kp + 1], packed[Kp + 1:])


def fb_hard_packed_idx(packed):
    """Hard-decision-only FB on a packed tensor: per-row argmax indices
    (idx (N,), pair_idx (N,) into the flattened (Kp, Kp) pair)."""
    Kp = packed.shape[1]
    logresp, logrespPair = _fb_messages(packed[0], packed[1:Kp + 1],
                                        packed[Kp + 1:])
    N = logresp.shape[0]
    return (torch.argmax(logresp, dim=-1),
            torch.argmax(logrespPair.reshape(N, Kp * Kp), dim=-1))


def posterior_log_marginals(log_alpha, log_beta):
    """h[t, i] = log_alpha + log_beta - logsumexp_i(...) (compute_h,
    GPI_HDP.py:3824-3862)."""
    s = log_alpha + log_beta
    return s - torch.logsumexp(s, dim=1, keepdim=True)


def normalize_log_quirk(x) -> np.ndarray:
    """The reference's heuristic log-row normaliser (normalize_log,
    GPI_HDP.py:4066-4083), not logsumexp: it rescales |x| by its max,
    flips it into [0, 1] weights, floors exact zeros at 1e-50 and
    returns the log of the weight simplex. Host numpy (a K-vector)."""
    x = np.asarray(x, dtype=np.float64).ravel()
    bound = 1e-50
    if np.max(x) == -np.inf:
        return np.repeat(np.log(bound), x.size)
    if not np.isclose(np.max(x), 0):
        aux = 1.0 - np.abs(x) / np.max(np.abs(x))
        aux = np.where(aux == 0, bound, aux)
        return np.log(aux / np.sum(aux))
    out = np.repeat(np.log(bound), x.size)
    out[int(np.argmax(x))] = 0.0
    return out


def baum_welch(log_alpha, log_beta, log_psi):
    """Baum-Welch (Rabiner) re-estimation from log messages
    (GPI_HDP.baum_welch, GPI_HDP.py:3864-3931). ``log_psi`` is the
    (T, K, K) log pair posterior of ``coupled_pair_log`` (row 0 is -inf,
    as in the reference). Returns numpy ``(log_pi, log_trans)``:
    log_pi = h[0]; log_trans[i, j] = logsumexp_t psi[t, i, j] -
    logsumexp_{t, j} psi[t, i, j] over t in [0, T-1) (the reference's
    range, which drops the last transition), each row then through
    ``normalize_log_quirk``."""
    h = posterior_log_marginals(log_alpha, log_beta)
    log_pi = h[0].cpu().numpy()
    psi = log_psi[:-1]
    num = torch.logsumexp(psi, dim=0).cpu().numpy()
    den = torch.logsumexp(psi, dim=(0, 2)).cpu().numpy()
    with np.errstate(invalid="ignore"):
        trans = num - den[:, None]
    trans = np.where(np.isneginf(num), -np.inf, trans)
    return log_pi, np.stack([normalize_log_quirk(row) for row in trans])


def entropy_terms(resp, respPair, eps=1e-30):
    """H[q] nonlinear ELBO terms (GPI_HDP.py:2682-2700)."""
    Hstart = -torch.sum(resp * torch.log(resp + eps), dim=0)
    sigma = respPair / (torch.sum(respPair, dim=2, keepdim=True) + eps) + eps
    Htable = -torch.sum(respPair * torch.log(sigma), dim=0)
    return torch.sum(Htable) + torch.sum(Hstart)
