"""Plain hard forward-backward over the beat sequence in float64
NumPy: the sequential recursions with the model's flooring constants
(forward: transition entries < 1e-6 and start entries < 1e-10 raised by
1e-4; backward: entries < 1e-5 raised by 1e-4 and each message divided
by the sum of all but its last entry), the coupled pair posterior, and
the first-maximum hard decisions."""

from __future__ import annotations

import numpy as np


def safe_exp_rows(x):
    """exp(x - rowmax), NaN -> 1e-8."""
    with np.errstate(invalid="ignore"):
        m = np.max(x, axis=-1, keepdims=True)
        return np.nan_to_num(np.exp(x - m), nan=1e-8)


def floor(M, below):
    return np.where(M < below, M + 1e-4, M)


def fb_hard_idx(packed: np.ndarray, dtype=np.float64):
    """``packed``: row 0 the start log-probabilities, rows 1..Kp the
    transition log-probabilities, the rest the (N, Kp) log evidence.
    Returns the hard state of each beat (N,) and the hard pair of each
    beat as an index into the flattened (Kp, Kp) pair (N,); computed in
    ``dtype``."""
    packed = np.asarray(packed, dtype)
    Kp = packed.shape[1]
    start, trans, logq = packed[0], packed[1:Kp + 1], packed[Kp + 1:]
    with np.errstate(invalid="ignore"):
        q_norm = logq - np.max(logq, axis=1, keepdims=True)
    N = q_norm.shape[0]
    q = safe_exp_rows(q_norm)
    pi = floor(np.exp(start), 1e-10)
    PiT = floor(safe_exp_rows(trans.T), 1e-6)
    alpha = np.empty((N, Kp), dtype)
    a = pi * q[0]
    alpha[0] = a / a.sum()
    for t in range(1, N):
        a = (PiT @ alpha[t - 1]) * q[t]
        alpha[t] = a / a.sum()
    PiB = floor(safe_exp_rows(trans), 1e-5)
    beta = np.empty((N, Kp), dtype)
    beta[-1] = 1.0
    for t in range(N - 2, -1, -1):
        b = PiB @ (beta[t + 1] * q[t + 1])
        beta[t] = b / np.sum(b[:-1])
    with np.errstate(divide="ignore"):
        idx = np.argmax(np.log(alpha * beta), axis=1)
    Pi = safe_exp_rows(trans)
    soft = q * beta
    pair = np.zeros((N, Kp, Kp), dtype)
    pair[1:] = alpha[:-1, :, None] * soft[1:, None, :] * Pi[None]
    den = pair.sum(axis=(1, 2), keepdims=True)
    den = np.where(den == 0, 1e-10, den)
    with np.errstate(divide="ignore"):
        lrp = np.log(pair / den)
    pidx = np.argmax(lrp.reshape(N, Kp * Kp), axis=1)
    return idx, pidx


def entropy_terms(resp, respPair, eps=1e-30) -> float:
    """Entropy terms of the hard responsibilities (start and transition
    tables)."""
    resp = np.asarray(resp, np.float64)
    respPair = np.asarray(respPair, np.float64)
    Hstart = -np.sum(resp * np.log(resp + eps), axis=0)
    sigma = respPair / (np.sum(respPair, axis=-1, keepdims=True) + eps) + eps
    Htable = -np.sum(respPair * np.log(sigma), axis=0)
    return float(np.sum(Htable) + np.sum(Hstart))
