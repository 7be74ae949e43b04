"""HDP stick-breaking global parameters in float64 NumPy: a frozen
copy of the program's host arithmetic (the bnpy formulation of the
rho/omega surrogate objective, optimised by scipy's L-BFGS-B with a
retry ladder of weaker tolerances; the Dirichlet posteriors of the
start and transition rows; the linear ELBO terms), with the two global
updates the benchmark's cells drive: the offline sweep's
(``global_update``) and the stream engine's chunk refresh
(``engine_refresh``), and the engine's one-sample linear terms
(``online_lin``)."""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import scipy.optimize
from scipy.special import digamma, gammaln, polygamma

EPS = 1e-8


# ---------------------------------------------------------------------------
# Stick-breaking transforms
# ---------------------------------------------------------------------------

def rho_to_beta(rho: np.ndarray, return_size: str = "K+1") -> np.ndarray:
    """E[beta] from stick proportions rho (GPI_HDP.py:431-439)."""
    rho = np.asarray(rho, dtype=np.float64)
    if return_size == "K":
        beta = rho.copy()
        beta[1:] *= np.cumprod(1.0 - rho[:-1])
    else:
        beta = np.append(rho, 1.0)
        beta[1:] *= np.cumprod(1.0 - rho)
    return beta


def create_init_rho(K: int) -> np.ndarray:
    """Near-uniform E[beta] initialisation (GPI_HDP.py:377-381)."""
    rem = np.minimum(0.1, 1.0 / (K * K))
    delta = (-1.0 + rem) * np.arange(0, K, 1, dtype=np.float64)
    return (1.0 - rem) / (K + delta)


def create_init_omega(K: int, n_doc: float, gamma: float) -> np.ndarray:
    return (n_doc / K + gamma) * np.ones(K)


def kvec(K: int) -> np.ndarray:
    return K + 1 - np.arange(1, K + 1)


def _c_beta(a1, a0):
    return np.sum(gammaln(a1 + a0) - gammaln(a1) - gammaln(a0))


# ---------------------------------------------------------------------------
# rho/omega objective (negative surrogate ELBO) + gradient
# ---------------------------------------------------------------------------

def _neg_elbo_and_grad(rho, omega, sum_log_pi, start_alpha_log_pi,
                       n_doc, gamma, alpha, kappa, want_grad=True):
    K = rho.size
    g1 = rho * omega
    g0 = (1.0 - rho) * omega
    dig_om = digamma(omega)
    Elogu = digamma(g1) - dig_om
    Elog1mu = digamma(g0) - dig_om

    if n_doc > 0:
        if kappa > 0:
            scale = 1.0
            on_coef = K + 1.0 - g1
            off_coef = K * kvec(K) + 1.0 + gamma - g0
            Tvec = alpha * sum_log_pi + start_alpha_log_pi
            Tvec = Tvec.copy()
            Tvec[:-1] += np.log(alpha + kappa) - np.log(kappa)
        else:
            scale = n_doc
            on_coef = 1.0 + (1.0 - g1) / scale
            off_coef = kvec(K) + (gamma - g0) / scale
            Tvec = alpha * sum_log_pi / scale + start_alpha_log_pi / scale
        Ebeta = np.append(rho, 1.0)
        Ebeta[1:] *= np.cumprod(1.0 - rho)
        local = np.inner(Ebeta, Tvec)
    else:
        scale = 1.0
        on_coef = 1.0 - g1
        off_coef = gamma - g0
        local = 0.0

    elbo = (-_c_beta(g1, g0) / scale
            + np.inner(on_coef, Elogu)
            + np.inner(off_coef, Elog1mu)
            + local)
    if not want_grad:
        return -elbo

    tri_om = polygamma(1, omega)
    tri_g1 = polygamma(1, g1)
    tri_g0 = polygamma(1, g0)
    if not (np.all(np.isfinite(tri_om)) and np.all(np.isfinite(tri_g1))):
        raise FloatingPointError("non-finite trigamma")
    grad_rho = on_coef * omega * tri_g1 - off_coef * omega * tri_g0
    grad_omega = (on_coef * (rho * tri_g1 - tri_om)
                  + off_coef * ((1.0 - rho) * tri_g0 - tri_om))
    if n_doc > 0:
        # d E[beta] / d rho, dense upper-triangular structure.
        Delta = np.tile(-Ebeta, (K, 1)) / (1.0 - rho)[:, None]
        dd = np.diag_indices(K)
        Delta[dd] *= -(1.0 - rho) / rho
        il = np.tril_indices(K, -1)
        Delta[il[0], il[1]] = 0.0
        grad_rho = grad_rho + Delta @ Tvec
    return -elbo, -np.hstack([grad_rho, grad_omega])


def _sigmoid(c):
    v = 1.0 / (1.0 + np.exp(-c))
    return np.minimum(np.maximum(v, EPS), 1.0 - EPS)


def _inv_sigmoid(v):
    return -np.log(1.0 / v - 1.0)


def find_optimum_rho_omega(sum_log_pi: np.ndarray,
                           start_alpha_log_pi: np.ndarray,
                           n_doc: float, gamma: float, alpha: float,
                           kappa: float = 0.0,
                           init_rho: Optional[np.ndarray] = None,
                           init_omega: Optional[np.ndarray] = None,
                           factr_list=(1e5, 1e7, 1e9, 1e10, 1e11),
                           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """L-BFGS-B in the unconstrained (sigmoid/log) parameterisation with
    the reference's retry ladder; raises ValueError if all retries fail.
    """
    sum_log_pi = np.squeeze(np.asarray(sum_log_pi, dtype=np.float64))
    K = sum_log_pi.size - 1
    if init_rho is None:
        init_rho = create_init_rho(K)
    init_rho = np.clip(init_rho, EPS, 1.0 - EPS)
    if init_omega is None:
        init_omega = create_init_omega(K, n_doc, gamma)
    init_omega = np.maximum(init_omega, EPS)

    c0 = np.hstack([_inv_sigmoid(init_rho), np.log(init_omega)])

    def obj(c):
        rho = _sigmoid(c[:K])
        omega = np.exp(c[K:])
        f, g = _neg_elbo_and_grad(rho, omega, sum_log_pi,
                                  start_alpha_log_pi, n_doc, gamma,
                                  alpha, kappa)
        return f, g * np.hstack([rho * (1.0 - rho), omega])

    last_err = None
    for factr in factr_list:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", category=RuntimeWarning,
                                    message="overflow")
            try:
                chat, fhat, info = scipy.optimize.fmin_l_bfgs_b(
                    obj, c0, factr=factr)
            except (RuntimeWarning, FloatingPointError, AssertionError) as e:
                last_err = e
                continue
        if info["warnflag"] > 1:
            last_err = ValueError(str(info["task"]))
            continue
        rho = np.clip(_sigmoid(chat[:K]), EPS, 1.0 - EPS)
        omega = np.exp(chat[K:])
        return rho, omega, float(fhat)

    if init_rho is not None:
        # Last-ditch: retry from the default initialisation.
        return find_optimum_rho_omega(
            sum_log_pi, start_alpha_log_pi, n_doc, gamma, alpha, kappa,
            init_rho=None, init_omega=None, factr_list=factr_list)
    raise ValueError(f"rho/omega optimisation failed: {last_err}")


# ---------------------------------------------------------------------------
# HDP global state + theta updates
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HDPGlobals:
    """rho/omega point estimates + Dirichlet posteriors over rows of Pi."""

    rho: np.ndarray          # (K,)
    omega: np.ndarray        # (K,)
    trans_theta: np.ndarray  # (K+1, K+1)
    start_theta: np.ndarray  # (K+1,)
    gamma: float
    trans_alpha: float
    start_alpha: float
    kappa: float

    @property
    def K(self) -> int:
        return self.rho.shape[0]


def calc_theta_full(glob: HDPGlobals, trans_counts, start_counts,
                    M: Optional[int] = None, rho: Optional[np.ndarray] = None,
                    kappa: Optional[float] = None):
    """Posterior Dirichlet params from transition counts
    (GPI_HDP.py:400-422)."""
    if M is None:
        M = glob.K + 1
    if rho is None:
        rho = glob.rho
    if kappa is None:
        kappa = glob.kappa
    size = "K" if M == rho.shape[0] else "K+1"
    Ebeta = rho_to_beta(rho, return_size=size)
    alphaEbeta = glob.trans_alpha * Ebeta

    trans_theta = np.zeros((M, M)) + alphaEbeta[None, :]
    tc = np.asarray(trans_counts, dtype=np.float64)
    trans_theta[:M - 1, :M - 1] += tc[:M - 1, :M - 1] + kappa * np.eye(M - 1)
    start_theta = glob.start_alpha * Ebeta.copy()
    start_theta[:M - 1] += np.asarray(start_counts, dtype=np.float64)[:M - 1]
    return trans_theta, start_theta


def calc_theta_post(glob: HDPGlobals, trans_counts, start_counts, M: int,
                    rho: np.ndarray):
    """Blended posterior used in ``post`` ELBO mode (GPI_HDP.py:383-398)."""
    Ebeta = rho_to_beta(rho, return_size="K+1")
    alphaEbeta = glob.trans_alpha * Ebeta
    trans_theta = np.zeros((M, M)) + alphaEbeta[None, :]
    trans_theta[:M - 1, :M - 1] += glob.trans_theta * 0.8
    tc = np.asarray(trans_counts, dtype=np.float64)
    trans_theta[:M, :M] += tc[:M, :M] * 0.2 + glob.kappa * np.eye(M)
    start_theta = glob.start_alpha * Ebeta.copy()
    start_theta[:M - 1] += glob.start_theta
    start_theta[:M] += np.asarray(start_counts, dtype=np.float64)[:M]
    return trans_theta, start_theta


def init_globals(M: int, gamma: float, trans_alpha: float,
                 start_alpha: float, kappa: float) -> HDPGlobals:
    """Uniform-count initialisation (GPI_HDP.py:353-358)."""
    rho = create_init_rho(M)
    omega = (1.0 + gamma) * np.ones(M)
    g = HDPGlobals(rho, omega, np.zeros((M + 1, M + 1)), np.zeros(M + 1),
                   gamma, trans_alpha, start_alpha, kappa)
    tt, st = calc_theta_full(g, np.ones((M, M)), np.ones(M), M + 1)
    return replace(g, trans_theta=tt, start_theta=st)


def reinit_globals(glob: HDPGlobals, M: int, trans_counts,
                   start_counts) -> HDPGlobals:
    rho = create_init_rho(M)
    omega = (1.0 + glob.gamma) * np.ones(M)
    g = replace(glob, rho=rho, omega=omega)
    tt, st = calc_theta_full(g, trans_counts, start_counts, M=M)
    return replace(g, trans_theta=tt, start_theta=st)


def expand_globals_tmp(glob: HDPGlobals, M: int, trans_counts, start_counts):
    """Temporary expansion to M clusters for candidate ELBO evaluation
    (GPI_HDP.py:365-375). Also handles M < len(rho) by truncation: after
    an emergency group removal (GPI_HDP.py:1451-1460) the stale globals
    can be one entry longer than the live cluster count; the reference's
    temp_reinit_global_params would raise on that state (latent crash,
    reachable e.g. on rec 107 under estimation_limit=300) — the extra
    stick belongs to the removed cluster, so dropping it is the
    consistent recovery."""
    rho_ = create_init_rho(M)
    k = min(glob.rho.shape[0], M)
    rho_[:k] = glob.rho[:k]
    omega_ = (1.0 + glob.gamma) * np.ones(M)
    omega_[:k] = glob.omega[:k]
    tt, st = calc_theta_full(glob, trans_counts, start_counts, M + 1, rho=rho_)
    return rho_, omega_, tt, st


def optimise_globals(glob: HDPGlobals, M: Optional[int] = None) -> HDPGlobals:
    """One find_optimum_rhoOmega step (GPI_HDP.py:2752-2828)."""
    jit = 1e-5
    tt = glob.trans_theta
    st = glob.start_theta
    dt = digamma(tt)
    ELogPi = dt - np.log(np.sum(np.exp(dt), axis=1) + jit)[:, None]
    sumELogPi = np.sum(ELogPi, axis=0)
    ds = digamma(st)
    startELogPi = ds - np.log(np.sum(np.exp(ds)) + jit)
    M_ = (glob.K + 1) if M is None else M
    try:
        rho, omega, _ = find_optimum_rho_omega(
            sumELogPi, glob.start_alpha * startELogPi, n_doc=M_,
            gamma=glob.gamma, alpha=glob.trans_alpha, kappa=glob.kappa,
            init_rho=np.array(glob.rho), init_omega=np.array(glob.omega))
    except ValueError:
        if glob.rho.size == glob.K:
            rho, omega = glob.rho, glob.omega
        else:
            omega = (glob.gamma + 1.0) * np.ones(glob.K)
            rho = 1.0 / (1.0 + glob.gamma) * np.ones(glob.K)
    return replace(glob, rho=np.asarray(rho), omega=np.asarray(omega))


# ---------------------------------------------------------------------------
# Linear ELBO terms (GPI_HDP.py:2651-2750)
# ---------------------------------------------------------------------------

def c_dir(AMat: np.ndarray) -> float:
    AMat = np.asarray(AMat)
    if AMat.ndim == 1:
        return float(gammaln(np.sum(AMat)) - np.sum(gammaln(AMat)))
    return float(np.sum(gammaln(np.sum(AMat, axis=1))) - np.sum(gammaln(AMat)))


def l_top(rho, omega, alpha, start_alpha, kappa, gamma) -> float:
    K = rho.size
    eta1 = rho * omega
    eta0 = (1.0 - rho) * omega
    dig_om = digamma(omega)
    ElogU = digamma(eta1) - dig_om
    Elog1mU = digamma(eta0) - dig_om

    diff_cBeta = K * _c_beta(1.0, gamma) - _c_beta(eta1, eta0)
    tAlpha = K * K * np.log(alpha) + K * np.log(start_alpha)
    if kappa > 0:
        coefU = K + 1.0 + eta1
        coef1mU = K * kvec(K) + 1.9 + gamma - eta0
        sumEbeta = np.sum(rho_to_beta(rho, return_size="K"))
        tBeta = sumEbeta * (np.log(alpha + kappa) - np.log(kappa))
        tKappa = K * (np.log(kappa) - np.log(alpha + kappa))
    else:
        coefU = (K + 1) + 1.0 - eta1
        coef1mU = (K + 1) * kvec(K) + gamma - eta0
        tBeta = 0.0
        tKappa = 0.0
    return float(tAlpha + tKappa + tBeta + diff_cBeta
                 + np.inner(coefU, ElogU) + np.inner(coef1mU, Elog1mU))


def elbo_linear_terms(rho, omega, alpha, start_alpha, kappa, gamma,
                      trans_theta, start_theta, start_counts,
                      trans_counts) -> float:
    """calcELBO_LinearTerms (GPI_HDP.py:2651-2680). Mutates a copy of
    trans_counts (the reference mutates in place; we keep that visible
    behaviour local)."""
    tc = np.array(trans_counts, dtype=np.float64, copy=True)
    Ltop = l_top(rho, omega, alpha, start_alpha, kappa, gamma)
    LdiffcDir = -c_dir(trans_theta) - c_dir(start_theta)
    K = tc.shape[0]
    size = "K" if start_theta.shape[0] == rho.size else "K+1"
    Ebeta = rho_to_beta(rho, return_size=size)
    LstartSlack = float(np.inner(
        start_counts + start_alpha * Ebeta - start_theta,
        digamma(start_theta) - digamma(np.sum(start_theta))))
    alphaEbetaPlusKappa = alpha * np.tile(Ebeta, (K, 1))
    alphaEbetaPlusKappa[:, :K] += kappa * np.eye(K)
    digammaSum = digamma(np.sum(trans_theta, axis=1))
    tc[:K, :] = tc[:K, :] + alphaEbetaPlusKappa
    LtransSlack = float(np.sum(
        (tc - trans_theta) * (digamma(trans_theta) - digammaSum[:, None])))
    return Ltop + LdiffcDir + LstartSlack + LtransSlack


def elbo_linears(glob: HDPGlobals, resp: np.ndarray, respPair: np.ndarray,
                 post: bool = False, one_sample: bool = False) -> float:
    """elbo_Linears wrapper (GPI_HDP.py:1025-1074): pads counts with an
    inactive-state column, temporarily expands globals if needed."""
    start_counts = np.asarray(resp[0], dtype=np.float64)
    trans_counts = np.sum(np.asarray(respPair, dtype=np.float64), axis=0)
    M = resp.shape[1]
    if start_counts.shape[0] == M:
        start_counts = np.hstack([start_counts, 0.0])
    if trans_counts.shape[-1] == M:
        trans_counts = np.hstack([trans_counts, np.zeros((M, 1))])
        trans_counts = np.vstack([trans_counts, np.zeros((1, M + 1))])

    if glob.rho.shape[0] == M:
        rho_, omega_ = glob.rho.copy(), glob.omega.copy()
        tt_, st_ = None, None
    else:
        rho_, omega_, tt_, st_ = expand_globals_tmp(
            glob, M, trans_counts.copy(), start_counts.copy())
    if post:
        if one_sample:
            tt_, st_ = calc_theta_full(glob, trans_counts.copy(),
                                       start_counts.copy(), M + 1, rho=rho_)
        else:
            tt_, st_ = calc_theta_post(glob, trans_counts.copy(),
                                       start_counts.copy(), M + 1, rho_)
    else:
        tt_, st_ = calc_theta_full(glob, trans_counts.copy(),
                                   start_counts.copy(), M + 1, rho=rho_)
    return elbo_linear_terms(rho_, omega_, glob.trans_alpha,
                             glob.start_alpha, glob.kappa, glob.gamma,
                             tt_, st_, start_counts, trans_counts)


# ---------------------------------------------------------------------------
# The global updates the cells drive
# ---------------------------------------------------------------------------

def global_update(resp, respPair, M: int, gamma, trans_alpha, start_alpha,
                  kappa, n_iters: int = 2) -> HDPGlobals:
    """The offline sweep's update from hard responsibilities (N, M):
    re-initialised sticks, then ``n_iters`` x (Dirichlet posteriors at
    M + 1, rho/omega optimisation)."""
    start_counts = np.asarray(resp, np.float64)[0]
    trans_counts = np.asarray(respPair, np.float64).sum(axis=0)
    glob = init_globals(M, gamma, trans_alpha, start_alpha, kappa)
    glob = reinit_globals(glob, M, trans_counts, start_counts)
    for _ in range(n_iters):
        tt, st = calc_theta_full(glob, trans_counts, start_counts, M + 1)
        glob = replace(glob, trans_theta=tt, start_theta=st)
        glob = optimise_globals(glob, M=M + 1)
    return glob


def engine_refresh(glob: HDPGlobals, start_counts, trans_counts,
                   M: int) -> HDPGlobals:
    """The stream engine's chunk refresh on the live counts (M, M):
    re-initialised sticks when M > 2, then 4 x (Dirichlet posteriors at
    M, rho/omega optimisation)."""
    sc = np.asarray(start_counts, np.float64)[:M]
    tc = np.asarray(trans_counts, np.float64)[:M, :M]
    if M > 2:
        glob = reinit_globals(glob, M - 1, tc, sc)
    for _ in range(4):
        tt, st = calc_theta_full(glob, tc, sc, M)
        glob = replace(glob, trans_theta=tt, start_theta=st)
        glob = optimise_globals(glob, M=M + 1)
    return glob


def online_lin(rho, omega, M: int, M_rho: int, start_counts, trans_counts,
               gamma, trans_alpha, start_alpha, kappa) -> float:
    """One-sample linear ELBO terms of the engine: rho/omega of live
    size M_rho widened to M with the initial sticks and 1 + gamma, the
    Dirichlet posteriors at M + 1, then the linear terms. Counts
    (M + 1,) and (M + 1, M + 1)."""
    rho_ = create_init_rho(M)
    omega_ = (1.0 + gamma) * np.ones(M)
    k = min(M_rho, M)
    rho_[:k] = np.asarray(rho, np.float64)[:k]
    omega_[:k] = np.asarray(omega, np.float64)[:k]
    glob = HDPGlobals(rho_, omega_, np.zeros((M + 1, M + 1)),
                      np.zeros(M + 1), gamma, trans_alpha, start_alpha,
                      kappa)
    sc = np.asarray(start_counts, np.float64)[:M + 1]
    tc = np.asarray(trans_counts, np.float64)[:M + 1, :M + 1]
    tt, st = calc_theta_full(glob, tc, sc, M + 1, rho=rho_)
    return elbo_linear_terms(rho_, omega_, trans_alpha, start_alpha, kappa,
                             gamma, tt, st, sc, tc)
