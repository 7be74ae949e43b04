"""Device-side HDP stick-breaking math with a DYNAMIC live-cluster count
M on fixed-size padded tensors (counterpart of hdpgpc_tpu.ops.sb_device).

These are masked versions of the host numpy functions in
ops/stick_breaking.py (the reference's bnpy-derived formulas,
OptimizerRhoOmega.py / GPI_HDP.py:2651-2750): every function takes M
as a 0-d integer tensor on the device and works on tensors padded to a
static ``Kp`` (max clusters + 1), masking inactive entries, so that the
streaming engine never reads M back to the host.

Used by the fused online streaming engine (models/stream_online.py),
where the whole per-beat decision, including the reference's
elbo_Linears accounting (GPI_HDP.py:1025-1074), runs on the device.

Conventions: rho/omega live in (Kp,) tensors with entries >= M_rho
inactive; counts live in (Kp+1,) / (Kp+1, Kp+1) tensors with entries
>= M inactive (the +1 row/col is the reference's inactive-state
padding). Every function broadcasts over leading dimensions: M may be
0-d or carry a batch shape, and the counts may carry a leading batch
dimension (the engine scores K candidate count matrices in one call).
Callers pass float64 tensors in both compute dtypes.
"""

from __future__ import annotations

import math

import torch

digamma = torch.special.digamma
gammaln = torch.lgamma

_TINY = 1e-300


def _m(M, like: torch.Tensor) -> torch.Tensor:
    """M as an integer tensor on ``like``'s device, with a trailing unit
    dim so that it broadcasts against a padded last axis."""
    return torch.as_tensor(M, device=like.device)[..., None]


def arange_mask(Kp: int, M, like: torch.Tensor) -> torch.Tensor:
    """(..., Kp) float mask of entries < M, in ``like``'s dtype."""
    idx = torch.arange(Kp, device=like.device)
    return (idx < _m(M, like)).to(like.dtype)


def create_init_rho_dyn(Kp: int, M, dtype=torch.float64,
                        device=None) -> torch.Tensor:
    """create_initrho (GPI_HDP.py:377-381) for a device M on (Kp,)
    tensors; entries >= M are zero."""
    Mt = torch.as_tensor(M, device=device)
    Mf = Mt.to(dtype)[..., None]
    rem = torch.clamp(1.0 / (Mf * Mf), max=0.1)
    idx = torch.arange(Kp, dtype=dtype, device=Mt.device)
    rho = (1.0 - rem) / (Mf + (-1.0 + rem) * idx)
    act = torch.arange(Kp, device=Mt.device) < Mt[..., None]
    return torch.where(act, rho, torch.zeros_like(rho))


def _cumprod_prev(x: torch.Tensor) -> torch.Tensor:
    """[1, x0, x0 x1, ...]: the exclusive running product on the last
    axis."""
    cp = torch.cumprod(x, -1)
    return torch.cat([torch.ones_like(x[..., :1]), cp[..., :-1]], -1)


def rho_to_beta_masked(rho: torch.Tensor, M) -> torch.Tensor:
    """E[beta] in the 'K+1' form on a (..., Kp+1) tensor: beta_i for
    i < M, the leftover stick at index M, zeros beyond (rho_to_beta,
    GPI_HDP.py:431-439)."""
    Kp = rho.shape[-1]
    act = arange_mask(Kp, M, rho)
    om = 1.0 - rho * act
    beta = rho * _cumprod_prev(om) * act               # (..., Kp)
    leftover = torch.prod(om, -1, keepdim=True)
    beta = beta.expand(leftover.shape[:-1] + (Kp,))
    full = torch.cat([beta, torch.zeros_like(leftover)], -1)
    idxs = torch.arange(Kp + 1, device=rho.device)
    return torch.where(idxs == _m(M, rho), leftover, full)


def calc_theta_full_masked(rho, M, trans_counts, start_counts,
                           trans_alpha, start_alpha, kappa):
    """_calcThetaFull (GPI_HDP.py:400-422) at size M+1 with rho of live
    size M (the 'K+1' Ebeta branch). trans_counts/start_counts: (...,
    Kp+1, Kp+1) / (..., Kp+1) with live entries < M. Returns padded
    (trans_theta, start_theta)."""
    Kp = rho.shape[-1]
    Ebeta = rho_to_beta_masked(rho, M)                 # (..., Kp+1)
    alphaEbeta = trans_alpha * Ebeta
    liveM = arange_mask(Kp + 1, M, rho)
    live2 = liveM[..., :, None] * liveM[..., None, :]
    eyeK = torch.eye(Kp + 1, dtype=rho.dtype, device=rho.device)
    tt = alphaEbeta[..., None, :] + (trans_counts + kappa * eyeK) * live2
    st = start_alpha * Ebeta + start_counts * liveM
    return tt, st


def c_dir_rows_masked(theta: torch.Tensor, M1) -> torch.Tensor:
    """c_Dir over the first M1 rows x M1 cols of a padded (..., Kp1,
    Kp1) matrix (GPI_HDP.py:2732-2750 matrix form)."""
    act = arange_mask(theta.shape[-1], M1, theta)
    live2 = act[..., None, :] * act[..., :, None]
    th = torch.where(live2 > 0, theta, torch.ones_like(theta))
    rowsum = torch.sum(theta * act[..., None, :], -1)
    rs = torch.where(act > 0, gammaln(torch.clamp(rowsum, min=_TINY)),
                     torch.zeros_like(rowsum))
    return torch.sum(rs, -1) - torch.sum(
        gammaln(torch.clamp(th, min=_TINY)) * live2, (-2, -1))


def c_dir_vec_masked(theta: torch.Tensor, M1) -> torch.Tensor:
    act = arange_mask(theta.shape[-1], M1, theta)
    th = torch.where(act > 0, theta, torch.ones_like(theta))
    s = torch.sum(theta * act, -1)
    return gammaln(torch.clamp(s, min=_TINY)) \
        - torch.sum(gammaln(torch.clamp(th, min=_TINY)) * act, -1)


def _c_beta_masked(a1, a0, act):
    t = gammaln(torch.clamp(a1 + a0, min=_TINY)) \
        - gammaln(torch.clamp(a1, min=_TINY)) \
        - gammaln(torch.clamp(a0, min=_TINY))
    return torch.sum(t * act, -1)


def l_top_masked(rho, omega, M, trans_alpha, start_alpha, kappa, gamma):
    """L_top (GPI_HDP.py:2702-2730) with live size M (the kappa > 0 and
    kappa == 0 branches)."""
    Kp = rho.shape[-1]
    dtype = rho.dtype
    act = arange_mask(Kp, M, rho)
    Mf = torch.as_tensor(M, device=rho.device).to(dtype)
    rho_s = torch.where(act > 0, rho, torch.full_like(rho, 0.5))
    om_s = torch.where(act > 0, omega, torch.full_like(omega, 2.0))
    eta1 = rho_s * om_s
    eta0 = (1.0 - rho_s) * om_s
    dig_om = digamma(om_s)
    ElogU = digamma(eta1) - dig_om
    Elog1mU = digamma(eta0) - dig_om

    diff_cBeta = Mf * (math.lgamma(1.0 + gamma) - math.lgamma(gamma)) \
        - _c_beta_masked(eta1, eta0, act)
    tAlpha = Mf * Mf * math.log(trans_alpha) + Mf * math.log(start_alpha)
    # kvec(M) = M + 1 - (1..M)
    kv = (Mf[..., None] + 1.0) - (torch.arange(Kp, dtype=dtype,
                                               device=rho.device) + 1.0)
    if kappa > 0:
        coefU = Mf[..., None] + 1.0 + eta1
        coef1mU = Mf[..., None] * kv + 1.9 + gamma - eta0
        # sum of E[beta] in the 'K' form (leftover stick excluded)
        sumEbeta = torch.sum(rho_s * _cumprod_prev(1.0 - rho_s * act) * act,
                             -1)
        tBeta = sumEbeta * (math.log(trans_alpha + kappa) - math.log(kappa))
        tKappa = Mf * (math.log(kappa) - math.log(trans_alpha + kappa))
    else:
        coefU = (Mf[..., None] + 1.0) + 1.0 - eta1
        coef1mU = (Mf[..., None] + 1.0) * kv + gamma - eta0
        tBeta = torch.zeros_like(Mf)
        tKappa = torch.zeros_like(Mf)
    return (tAlpha + tKappa + tBeta + diff_cBeta
            + torch.sum(coefU * ElogU * act, -1)
            + torch.sum(coef1mU * Elog1mU * act, -1))


def elbo_linear_terms_masked(rho, omega, M, M_rho, trans_alpha,
                             start_alpha, kappa, gamma,
                             trans_theta, start_theta,
                             start_counts, trans_counts):
    """calcELBO_LinearTerms (GPI_HDP.py:2651-2680) on padded tensors.

    M: live cluster count (counts live in entries < M; thetas in entries
    < M+1). M_rho: live rho size for L_top (== M after the
    expand_globals_tmp padding the caller performs)."""
    Kp = rho.shape[-1]
    M1 = torch.as_tensor(M, device=rho.device) + 1
    Ltop = l_top_masked(rho, omega, M_rho, trans_alpha, start_alpha,
                        kappa, gamma)
    LdiffcDir = -c_dir_rows_masked(trans_theta, M1) \
        - c_dir_vec_masked(start_theta, M1)
    Ebeta = rho_to_beta_masked(rho, M_rho)             # (..., Kp+1)
    actM1 = arange_mask(Kp + 1, M1, rho)
    st_safe = torch.where(actM1 > 0, start_theta,
                          torch.ones_like(start_theta))
    dig_st = digamma(st_safe)
    dig_st_sum = digamma(torch.clamp(
        torch.sum(start_theta * actM1, -1), min=_TINY))[..., None]
    LstartSlack = torch.sum(
        (start_counts + start_alpha * Ebeta - start_theta)
        * (dig_st - dig_st_sum) * actM1, -1)
    eyeK = torch.eye(Kp + 1, dtype=rho.dtype, device=rho.device)
    aEbK = trans_alpha * Ebeta[..., None, :] + kappa * eyeK
    live2 = actM1[..., :, None] * actM1[..., None, :]
    tt_safe = torch.where(live2 > 0, trans_theta,
                          torch.ones_like(trans_theta))
    digammaSum = digamma(torch.clamp(
        torch.sum(trans_theta * actM1[..., None, :], -1), min=_TINY))
    tc_adj = trans_counts + aEbK
    LtransSlack = torch.sum((tc_adj - trans_theta)
                            * (digamma(tt_safe) - digammaSum[..., :, None])
                            * live2, (-2, -1))
    return Ltop + LdiffcDir + LstartSlack + LtransSlack


def elbo_linears_online(rho, omega, M, M_rho, trans_alpha, start_alpha,
                        kappa, gamma, start_counts, trans_counts):
    """elbo_Linears for the online one_sample path (GPI_HDP.py:1025-1074
    with one_sample=True): expand rho/omega to size M when M_rho < M
    (expand_globals_tmp: pad with the create_initrho(M) tail and
    1 + gamma), recompute theta via _calcThetaFull at M+1, then the
    linear terms. counts: (..., Kp+1, ...) padded, live < M."""
    Kp = rho.shape[-1]
    dev = rho.device
    Mt = torch.as_tensor(M, device=dev)
    Mr = torch.as_tensor(M_rho, device=dev)
    need = (Mr != Mt)[..., None]
    rho_init = create_init_rho_dyn(Kp, Mt, rho.dtype)
    idx = torch.arange(Kp, device=dev)
    in_rho = idx < Mr[..., None]
    rho_exp = torch.where(in_rho, rho, rho_init)
    rho_exp = torch.where(idx < Mt[..., None], rho_exp,
                          torch.zeros_like(rho_exp))
    om_exp = torch.where(in_rho, omega, torch.full_like(omega, 1.0 + gamma))
    rho_ = torch.where(need, rho_exp, rho)
    omega_ = torch.where(need, om_exp, omega)
    tt, st = calc_theta_full_masked(rho_, Mt, trans_counts, start_counts,
                                    trans_alpha, start_alpha, kappa)
    return elbo_linear_terms_masked(rho_, omega_, Mt, Mt, trans_alpha,
                                    start_alpha, kappa, gamma, tt, st,
                                    start_counts, trans_counts)
