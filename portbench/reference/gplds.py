"""Plain GP-LDS cluster model in float64: the cluster refit of the
offline sweep, and the one-beat primitives of the online engine.

Written from the model's equations (the port's models/gplds.py is the
map, not an import): a sequential Kalman filter over a cluster's
members with one-step Matrix-Normal-Inverse-Wishart updates of (A,
Gamma) and (C, Sigma) until the estimation limit, a full RTS smoother,
the emission scores of every beat and the latent scores of every
member. No parallel scan, no frozen-tail shortcut, no hand-written
kernel: every solve is a Cholesky of ``torch.linalg``. Every tensor is
float64 (the dtype of the caller's tensors: the control runs it in
float32 under ``precision.tf32()``); the device is the caller's.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch

LOG2PI = math.log(2.0 * math.pi)


def t_(M):
    return M.transpose(-1, -2)


def sym(M):
    return 0.5 * (M + t_(M))


def eye(T, like):
    return torch.eye(T, dtype=like.dtype, device=like.device)


def dmean(M):
    return torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1).abs().mean(-1),
                       min=torch.finfo(M.dtype).eps)


def jitter(M, scale):
    """sym(M) + scale * mean|diag| on the diagonal."""
    M = sym(M)
    return M + (scale * dmean(M))[..., None, None] * eye(M.shape[-1], M)


def chol(M):
    return torch.linalg.cholesky(sym(M))


def cho_solve(L, B):
    return torch.cholesky_solve(B, L)


def solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def rbf(x, outputscale, lengthscale):
    """outputscale * exp(-0.5 (x - x')^2 / lengthscale^2) on a 1-D grid."""
    d2 = (x[:, None] - x[None, :]) ** 2
    return outputscale * torch.exp(-0.5 * d2 / lengthscale ** 2)


def gaussian_score(diff, cov):
    """-0.5 d' cov^-1 d - 0.5 T log 2 pi (no log-determinant) with the
    model's 1e-8 relative jitter; diff (..., T), cov (..., T, T)."""
    d = diff[..., None]
    L = chol(jitter(cov, 1e-8))
    s = solve_lower(L, d)
    return -0.5 * torch.sum(s ** 2, (-2, -1)) - 0.5 * d.shape[-2] * LOG2PI


class Cluster(NamedTuple):
    """One cluster's dynamic state (unbatched, float64)."""
    theta_noise: torch.Tensor   # () white-noise variance of the kernel
    K0: torch.Tensor            # (T, T) kernel Gram on the basis
    Gamma_def: torch.Tensor     # (T, T) prior latent noise
    Sigma_def: torch.Tensor     # (T, T) prior observation noise
    n: int                      # members included
    f: torch.Tensor             # (T, 1) filtered mean, last member
    P: torch.Tensor             # (T, T)
    A: torch.Tensor
    Gamma: torch.Tensor
    C: torch.Tensor
    Sigma: torch.Tensor
    mniw_mean: torch.Tensor     # (2, T, T): internal (A), observation (C)
    mniw_row_cov: torch.Tensor  # (2, T, T)
    mniw_n0: torch.Tensor       # (2,)
    mniw_scale: torch.Tensor    # (2, T, T)


def fresh_cluster(x, outputscale, lengthscale, noise, gamma_def,
                  sigma_def, free_deg) -> Cluster:
    """A cluster after its kernel fit, before any member: zero mean,
    the kernel Gram as covariance, A = C = I, the prior noises, MNIW
    priors anchored there."""
    dt = x.dtype
    T = x.shape[0]
    I = eye(T, x)
    K0 = rbf(x, torch.as_tensor(outputscale, dtype=dt, device=x.device),
             torch.as_tensor(lengthscale, dtype=dt, device=x.device))
    G = gamma_def * I
    S = sigma_def * I
    return Cluster(
        theta_noise=torch.as_tensor(noise, dtype=dt, device=x.device),
        K0=K0, Gamma_def=G, Sigma_def=S, n=0,
        f=torch.zeros((T, 1), dtype=dt, device=x.device), P=K0,
        A=I, Gamma=G, C=I, Sigma=S,
        mniw_mean=torch.stack([I, I]), mniw_row_cov=torch.stack([I, I]),
        mniw_n0=torch.full((2,), float(free_deg), dtype=dt,
                           device=x.device),
        mniw_scale=torch.stack([G, S]))


class StepOut(NamedTuple):
    f: torch.Tensor
    P: torch.Tensor
    A: torch.Tensor
    Gamma: torch.Tensor
    C: torch.Tensor
    Sigma: torch.Tensor
    f_smp: torch.Tensor        # the previous state smoothed on this one
    P_smp: torch.Tensor
    mniw: tuple                # (mean, row_cov, n0, scale) after


def member_step(c: Cluster, y, limit, *, update_params=True,
                pair_smooth=True, annealing=True) -> StepOut:
    """Include one member beat y (..., T): Kalman update (the first
    member's prediction is the prior with white-noise innovations), the
    previous state smoothed on it, and, from the second member on and
    while the member count stays under ``limit``, the one-step MNIW
    updates whose posterior means and scales become (A, C) and (Gamma,
    Sigma). Leading dimensions are clusters that hold the same number of
    members."""
    T = y.shape[-1]
    I = eye(T, c.P)
    first = c.n == 0
    m = c.A @ c.f
    P_pred_dyn = c.A @ c.P @ t_(c.A) + c.Gamma
    P_pred = c.P if first else P_pred_dyn
    y_pred = torch.zeros_like(m) if first else c.C @ m
    R = c.theta_noise[..., None, None] * I if first else c.Sigma
    S_in = sym(c.C @ P_pred @ t_(c.C) + R)
    K = t_(cho_solve(chol(S_in), c.C @ P_pred))
    f_up = m + K @ (y[..., None] - y_pred)
    IKC = I - K @ c.C
    P_up = IKC @ P_pred @ t_(IKC) + K @ R @ t_(K)
    if pair_smooth and c.n >= 1:
        Jg = t_(cho_solve(chol(sym(P_pred_dyn)), c.A @ c.P))
        f_smp = c.f + Jg @ (f_up - c.A @ c.f)
        P_smp = c.P + Jg @ (P_up - P_pred_dyn) @ t_(Jg)
    else:
        f_smp, P_smp = c.f, c.P
    f_reg = f_smp if pair_smooth else c.f
    mean, row_cov, n0, scale = (c.mniw_mean, c.mniw_row_cov, c.mniw_n0,
                                c.mniw_scale)
    A, G, C, S = c.A, c.Gamma, c.C, c.Sigma
    N_new = c.n + 1
    if update_params:
        if c.n >= 1 and N_new < limit:
            jit2 = 1e-2 * dmean(scale)
            V = sym(row_cov) + jit2[..., None, None] * I
            V_inv = cho_solve(chol(V), I.expand(V.shape))
            Y1 = torch.stack([f_up, y[..., None]], -3)
            Y2 = torch.stack([f_reg, f_up], -3)
            S_h = Y2 @ t_(Y2) + V_inv
            S_x = Y1 @ t_(Y2) + mean @ V_inv
            part = t_(cho_solve(chol(sym(S_h) + 1e-8 * I), t_(S_x)))
            new_n0 = n0 + 1.0
            c0 = ((n0 - 2.0) / (new_n0 - 2.0))[..., None, None]
            c1 = (1.0 / (new_n0 - 2.0))[..., None, None]
            e = Y1 - Y2
            mean = c0 * mean + c1 * part
            scale = c0 * scale + c1 * (e @ t_(e))
            row_cov, n0 = S_h, new_n0
        if N_new < limit:
            if c.n >= 1:
                GS = scale * (n0 / (n0 - 2.0))[..., None, None]
            else:
                GS = torch.stack([G, S], -3)
            if annealing:
                d = torch.stack([dmean(c.Gamma_def), dmean(c.Sigma_def)],
                                -1)
                GS = GS + (d / N_new ** 2)[..., None, None] * I
            A, C = mean[..., 0, :, :], mean[..., 1, :, :]
            G, S = GS[..., 0, :, :], GS[..., 1, :, :]
    return StepOut(f_up, P_up, A, G, C, S, f_smp, P_smp,
                   (mean, row_cov, n0, scale))


def advance(c: Cluster, o: StepOut) -> Cluster:
    return c._replace(n=c.n + 1, f=o.f, P=o.P, A=o.A, Gamma=o.Gamma, C=o.C,
                      Sigma=o.Sigma, mniw_mean=o.mniw[0],
                      mniw_row_cov=o.mniw[1], mniw_n0=o.mniw[2],
                      mniw_scale=o.mniw[3])


def rts_pair(f_prev, P_prev, f_cur, P_cur, A, Gamma):
    """Condition (f_prev, P_prev) on the smoothed (f_cur, P_cur)."""
    P_pred = A @ P_prev @ t_(A) + Gamma
    J = t_(cho_solve(chol(sym(P_pred)), A @ t_(P_prev)))
    return f_prev + J @ (f_cur - A @ f_prev), \
        P_prev + J @ (P_cur - P_pred) @ t_(J)


def _take(c: Cluster, a: int) -> Cluster:
    """The first ``a`` clusters of a stacked Cluster."""
    return Cluster(*[v if isinstance(v, int) else v[:a] for v in c])


def _put(full, part):
    """``full`` with its first clusters replaced by ``part``."""
    if isinstance(full, int):
        return part
    return torch.cat([part, full[part.shape[0]:]])


def refit(c0s, Y, members, est_limit) -> List[Dict[str, torch.Tensor]]:
    """Refit clusters from their starts ``c0s`` (a list of Cluster) on
    their members (a list of bool (N,)) of the beats Y (N, T), in Y's
    dtype; returns for each its emission scores q (N,), latent scores
    q_lat (N,) and final (A, Gamma, C, Sigma).

    The clusters are filtered together, the s-th member of every cluster
    that has one in one batch, then smoothed together likewise."""
    limit = math.inf if est_limit is None else float(est_limit)
    midx = [torch.nonzero(m).reshape(-1) for m in members]
    order = sorted(range(len(c0s)), key=lambda k: -int(midx[k].shape[0]))
    B = [int(midx[k].shape[0]) for k in order]
    out = [None] * len(c0s)
    if not c0s or B[0] == 0:
        for k in range(len(c0s)):
            out[k] = _scores(c0s[k], Y, members[k], midx[k], [], [])
        return out
    c = Cluster(*[v if isinstance(v, int) else torch.stack(
        [getattr(c0s[k], f) for k in order])
        for f, v in zip(Cluster._fields, c0s[order[0]])])
    steps = []             # per member slot: (f, P, A, Gamma, C, Sigma)
    for s in range(B[0]):
        a = sum(b > s for b in B)
        part = _take(c, a)._replace(n=s)
        ys = torch.stack([Y[midx[order[i]][s]] for i in range(a)])
        part = advance(part, member_step(part, ys, limit))
        c = Cluster(*[_put(v, p) for v, p in zip(c, part)])
        steps.append((part.f, part.P, part.A, part.Gamma, part.C,
                      part.Sigma))
    # full RTS smoother over each cluster's member slots, the step's own
    # (A, Gamma)
    sm = [None] * len(steps)
    sm[-1] = steps[-1][:2]
    for s in range(len(steps) - 2, -1, -1):
        f, P, A, G = steps[s][:4]
        a = sm[s + 1][0].shape[0]
        fs, Ps = rts_pair(f[:a], P[:a], sm[s + 1][0], sm[s + 1][1], A[:a],
                          G[:a])
        sm[s] = (torch.cat([fs, f[a:]]), torch.cat([Ps, P[a:]]))
    for i, k in enumerate(order):
        out[k] = _scores(c0s[k], Y, members[k], midx[k],
                         [tuple(v[i] for v in st) for st in steps[:B[i]]],
                         [tuple(v[i] for v in st) for st in sm[:B[i]]])
    return out


def _scores(c0: Cluster, Y, members, midx, filt, smooth
            ) -> Dict[str, torch.Tensor]:
    """One cluster's scores and final (A, Gamma, C, Sigma) from its
    filtered states ``filt`` [(f, P, A, Gamma, C, Sigma)] and smoothed
    states ``smooth`` [(f, P)], one a member slot.

    Each member is scored against its own filtered state after its
    inclusion; a non-member against the state after the member before
    the member that precedes it (slot pos - 1). The first member's score
    covariance is inflated by 1e-2 mean(diag Sigma_def). Scores omit the
    log-determinant, as the model does."""
    N, T = Y.shape
    I = eye(T, Y)
    B = len(filt)
    if B == 0:
        z = torch.zeros(N, dtype=Y.dtype, device=Y.device)
        return dict(q=z, q_lat=z.clone(), A=c0.A, Gamma=c0.Gamma, C=c0.C,
                    Sigma=c0.Sigma)
    f_f, _P, A_s, G_s, C_s, S_s = (list(v) for v in zip(*filt))
    # emission scores of every beat: a member against its own slot, the
    # first member against slot 0 with the inflated covariance, a
    # non-member against slot pos - 1
    S_all = torch.stack(S_s + [S_s[0] + 1e-2 * dmean(c0.Sigma_def) * I])
    L_all = chol(jitter(S_all, 1e-8))
    means = torch.stack([(C @ f)[:, 0] for C, f in zip(C_s, f_f)])
    pos = torch.cumsum(members.to(torch.int64), 0) - 1
    slot = torch.where(members, pos.clamp(0, B - 1),
                       (pos.clamp(min=1) - 1).clamp(0, B - 1))
    fac = torch.where(members & (pos == 0), B, slot)
    d = solve_lower(L_all[fac], (Y - means[slot])[..., None])
    q = -0.5 * torch.sum(d[..., 0] ** 2, -1) - 0.5 * T * LOG2PI
    # latent scores of the members: slot 0 against itself with the
    # final (A, Gamma), slot s against slot s - 1 with slot s's
    A_j = torch.stack([A_s[-1]] + A_s[1:])
    G_j = torch.stack([G_s[-1]] + G_s[1:])
    fs = torch.stack([v[0] for v in smooth])
    Ps = torch.stack([v[1] for v in smooth])
    prev = torch.cat([fs[:1], fs[:-1]])
    cov = torch.cat([Ps[:1], Ps[:-1]])
    L2 = chol(jitter(G_j, 1e-8))
    r = solve_lower(L2, fs - A_j @ prev)
    tr = torch.sum(A_j * (cho_solve(L2, A_j) @ cov), (-2, -1))
    q_lat = torch.zeros(N, dtype=Y.dtype, device=Y.device)
    q_lat[midx] = (-0.5 * (torch.sum(r[..., 0] ** 2, -1) + tr)
                   - 0.5 * T * LOG2PI)
    return dict(q=q, q_lat=q_lat, A=A_s[-1], Gamma=G_s[-1], C=C_s[-1],
                Sigma=S_s[-1])


def mniw_loglik(prior_mean, prior_row_cov, prior_scale, M, Sigma):
    """Partial MNIW log-density of (M, Sigma) under a prior (mean, row
    covariance, scale)."""
    I = eye(M.shape[-1], M)
    L = chol(sym(Sigma) + 1e-8 * I)
    D = M - prior_mean
    mean_lik = -0.5 * torch.sum((D @ prior_row_cov) * cho_solve(L, D))
    scale_lik = -0.5 * torch.trace(cho_solve(L, prior_scale))
    return mean_lik + scale_lik


def lds_param_elbo(A, Gamma, C, Sigma, Gamma_def, Sigma_def, A_def=None,
                   C_def=None):
    """MNIW log-densities of (A, Gamma) and (C, Sigma) under priors
    anchored at (A_def, Gamma_def) and (C_def, Sigma_def) with identity
    row covariances (A_def = C_def = I unless given), scaled by
    100 / T."""
    T = A.shape[-1]
    I = eye(T, A)
    A_def = I if A_def is None else A_def
    C_def = I if C_def is None else C_def
    return (mniw_loglik(A_def, I, Gamma_def, A, Gamma)
            + mniw_loglik(C_def, I, Sigma_def, C, Sigma)) / T * 100.0
