"""First-sample GP kernel hyperparameter fit (counterpart of the exact
path of hdpgpc_tpu.models.kernel_fit; reference GPI.fit_torch,
GPI.py:610-770, ExactGPModel of GPI_models_pytorch.py:10-22).

Maximise the exact GP marginal likelihood of ONE beat y(x) under

    k(x, x') = s * exp(-0.5 (x-x')^2 / l^2) + n * 1[x == x']
    mean(x)  = c                                  (ConstantMean)

with Adam (lr=0.1) for up to ``max_iters`` iterations, stopping once
more than 1000 iterations have run and the last ten loss deltas sum to
~0 (GPI.py:695-698). softplus for outputscale / lengthscale (raw init
0), an interval sigmoid for the noise (raw init 0 -> midpoint of the
bounds), loss = negative mean log marginal likelihood. The lengthscale
is PINNED to 1.2 on write-back (GPI.py:711).

The Adam update is written out in the order of operations of optax's
``scale_by_adam`` followed by ``scale(-lr)`` and ``apply_updates``,
which the JAX reference uses; gradients come from autograd through
``torch.linalg``.

The inducing-point fits follow (kernel_fit.py:230-554): the collapsed
SGPR bound (``fit_kernel_sgpr``, the reference's ProjectedGPModel) and
the whitened uncollapsed SVGP bound (``fit_kernel_svgp``,
VarProjectedGPModel), each with learnable inducing locations, up to
5000 Adam iterations, the same plateau stop and NO lengthscale pin;
their Grams are built inline, as in the reference, so that autograd
runs through them. ``fit_kernel_scipy`` is the legacy L-BFGS-B fit and
``GP_MODEL_ZOO`` / ``fit_kernel_zoo`` the reference's model-zoo
registry, with the fits that hdpgpc_torch does not mirror fenced.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from hdpgpc_torch.device import DEFAULT_DEVICE, resolve_device
from hdpgpc_torch.ops import linalg
from hdpgpc_torch.ops.kernels import KernelParams

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# how often (in iterations, past the 1000-iteration plateau floor) the
# host reads the per-lane stop flags; finished lanes are frozen on the
# device in between, so the result does not depend on it
_CHECK_EVERY = 25


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus switches to
    # the identity above 20, which shifts large outputscales
    return torch.logaddexp(x, torch.zeros_like(x))


def adam_update(p, g, mu, nu, lr, bc1, bc2):
    """One optax.adam step in optax's order of operations
    (``scale_by_adam`` with eps outside the square root, ``scale(-lr)``,
    ``apply_updates``). ``bc1``/``bc2`` are the bias corrections
    1 - b1^count and 1 - b2^count of this step (floats, or tensors that
    broadcast against p). Returns (p', mu', nu')."""
    m = (1 - _B1) * g + _B1 * mu
    v = (1 - _B2) * (g ** 2) + _B2 * nu
    upd = (m / bc1) / (torch.sqrt(v / bc2 + 0.0) + _EPS)
    return p + (-lr) * upd, m, v


def _interval(raw_n, n_lb, n_ub):
    """The noise from its raw parameter: an interval sigmoid."""
    return n_lb + (n_ub - n_lb) * torch.sigmoid(raw_n)


def _rbf(s, lsc, a, b):
    """s * exp(-0.5 (a - b)^2 / lsc^2) on 1-D grids a, b; s and lsc
    broadcast (the batched exact fit gives them (B, 1, 1))."""
    d2 = (a[:, None] - b[None, :]) ** 2
    return s * torch.exp(-torch.clamp(0.5 * d2 / (lsc ** 2), max=700.0))


def _nll(raw_s, raw_l, raw_n, c, n_lb, n_ub, x, y):
    """Negative mean log marginal likelihood per lane: raw params (B,),
    x (T,), y (B, T) -> (B,)."""
    s = _softplus(raw_s)[:, None, None]
    # floor inert on sane trajectories; engages only if Adam diverges
    lsc = torch.clamp(_softplus(raw_l), min=1e-6)[:, None, None]
    n = _interval(raw_n, n_lb, n_ub)[:, None, None]
    T = x.shape[0]
    K = _rbf(s, lsc, x, x) + n * torch.eye(T, dtype=x.dtype, device=x.device)
    L = linalg.chol(K)
    r = (y - c[:, None])[..., None]
    alpha = linalg.cho_solve(L, r)
    ll = (-0.5 * torch.sum(r * alpha, dim=(-2, -1))
          - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
          - 0.5 * T * math.log(2.0 * math.pi))
    return -ll / T


def _adam_fit(x, Ys, n_lb, n_ub, max_iters: int, lr: float):
    """Adam over B independent lanes; a lane stops (and is frozen) at
    its own plateau, so every lane equals its solo fit."""
    B = Ys.shape[0]
    dt, dev = x.dtype, x.device
    params = [torch.zeros(B, dtype=dt, device=dev) for _ in range(4)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    count = torch.zeros(B, dtype=torch.int64, device=dev)
    buf = torch.zeros((B, 11), dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for it in range(max_iters):
        tp = [p.detach().requires_grad_(True) for p in params]
        loss = _nll(*tp, n_lb, n_ub, x, Ys)
        grads = torch.autograd.grad(loss.sum(), tp)
        loss = loss.detach()
        active = ~done
        count_new = count + 1
        cf = count_new.to(torch.float64)
        bc1 = (1 - torch.pow(torch.full_like(cf, _B1), cf)).to(dt)
        bc2 = (1 - torch.pow(torch.full_like(cf, _B2), cf)).to(dt)
        for k, g in enumerate(grads):
            p_new, m_k, v_k = adam_update(params[k], g, mu[k], nu[k], lr,
                                          bc1, bc2)
            params[k] = torch.where(active, p_new, params[k])
            mu[k] = torch.where(active, m_k, mu[k])
            nu[k] = torch.where(active, v_k, nu[k])
        count = torch.where(active, count_new, count)
        buf_new = torch.cat([buf[:, 1:], loss[:, None]], 1)
        buf = torch.where(active[:, None], buf_new, buf)
        if it > 1000:
            plateau = torch.abs(torch.sum(buf[:, 1:] - buf[:, :-1], 1)) \
                < 1e-4
            done = done | (active & plateau)
            if (it - 1000) % _CHECK_EVERY == 0 and bool(done.all()):
                break
    raw_s, _raw_l, raw_n, _c = params
    return _softplus(raw_s), _interval(raw_n, n_lb, n_ub)


def fit_kernel(x_basis, y, bound_sigma: Tuple[float, float],
               pin_lengthscale: float = 1.2, max_iters: int = 4000,
               lr: float = 0.1, dtype=torch.float64,
               device=DEFAULT_DEVICE) -> KernelParams:
    """Fit (outputscale, lengthscale, noise) on one beat; lengthscale is
    pinned on write-back (GPI.py:711). x_basis: (T,) or (T, 1); y: (T,)."""
    return fit_kernel_batch(x_basis, np.array(y).reshape(1, -1),
                            bound_sigma, pin_lengthscale=pin_lengthscale,
                            max_iters=max_iters, lr=lr, dtype=dtype,
                            device=device)[0]


def fit_kernel_batch(x_basis, Ys, bound_sigma: Tuple[float, float],
                     pin_lengthscale: float = 1.2, max_iters: int = 4000,
                     lr: float = 0.1, dtype=torch.float64,
                     device=DEFAULT_DEVICE) -> List[KernelParams]:
    """fit_kernel over B seed beats Ys (B, T) at once; each lane equals
    its solo fit. Returns B KernelParams of 0-d tensors on ``device``."""
    device = resolve_device(device)
    x = torch.as_tensor(x_basis, dtype=dtype, device=device).reshape(-1)
    Ys = torch.as_tensor(np.array(Ys), dtype=dtype, device=device).reshape(
        -1, x.shape[0])
    lb = torch.tensor(bound_sigma[0], dtype=dtype, device=device)
    ub = torch.tensor(bound_sigma[1], dtype=dtype, device=device)
    s, n = _adam_fit(x, Ys, lb, ub, max_iters, lr)
    pin = torch.tensor(pin_lengthscale, dtype=dtype, device=device)
    return [KernelParams(outputscale=s[b], lengthscale=pin, noise=n[b])
            for b in range(Ys.shape[0])]


# ---------------------------------------------------------------------------
# Inducing-point fits (kernel_fit.py:230-466)
# ---------------------------------------------------------------------------


def _sgpr_nll(p: dict, n_lb, n_ub, x, y):
    """Negative collapsed SGPR bound (Titsias), mean over the samples:
    -1/2 y'(Q + s2 I)^-1 y - 1/2 logdet(Q + s2 I) - n/2 log 2pi
    - 1/(2 s2) tr(K - Q), Q = Knm Kmm^-1 Kmn (kernel_fit.py:243-277)."""
    s = _softplus(p["raw_s"])
    lsc = torch.clamp(_softplus(p["raw_l"]), min=1e-6)
    s2 = _interval(p["raw_n"], n_lb, n_ub)
    Z = p["Z"]
    n, m = x.shape[0], Z.shape[0]
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    Kmm = _rbf(s, lsc, Z, Z) + 1e-6 * s * eye
    Knm = _rbf(s, lsc, x, Z)
    Lm = linalg.chol(Kmm)
    A = linalg.solve_lower(Lm, Knm.T) / torch.sqrt(s2)          # (m, n)
    LB = linalg.chol(eye + A @ A.T)
    r = y - p["c"]
    Ar = A @ r / torch.sqrt(s2)
    cvec = linalg.solve_lower(LB, Ar[:, None])[:, 0]
    quad = torch.sum(r * r) / s2 - torch.sum(cvec ** 2)
    logdet = (torch.sum(torch.log(torch.diagonal(LB) ** 2))
              + n * torch.log(s2))
    trace = (n * s - torch.sum(A * A) * s2) / s2
    ll = (-0.5 * quad - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)
          - 0.5 * trace)
    return -ll / n


def _svgp_nelbo(p: dict, n_lb, n_ub, x, y):
    """Negative SVGP evidence lower bound, mean over the samples, in
    gpytorch's whitened form q(v) = N(m_v, Lv Lv'), u = Lm v
    (kernel_fit.py:345-389)."""
    s = _softplus(p["raw_s"])
    lsc = torch.clamp(_softplus(p["raw_l"]), min=1e-6)
    s2 = _interval(p["raw_n"], n_lb, n_ub)
    Z, m_v, L_raw = p["Z"], p["m_v"], p["L_raw"]
    n, m = x.shape[0], Z.shape[0]
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    Lm = linalg.chol(_rbf(s, lsc, Z, Z) + 1e-6 * s * eye)
    A = linalg.solve_lower(Lm, _rbf(s, lsc, Z, x))              # (m, n)
    Lv = torch.tril(L_raw, diagonal=-1) \
        + torch.diag(_softplus(torch.diagonal(L_raw)))
    mu = A.T @ m_v + p["c"]
    AtLv = A.T @ Lv
    var = s - torch.sum(A * A, dim=0) + torch.sum(AtLv * AtLv, dim=1)
    r = y - mu
    exp_ll = (-0.5 * torch.sum(r * r + var) / s2
              - 0.5 * n * torch.log(2.0 * math.pi * s2))
    kl = 0.5 * (torch.sum(Lv * Lv) + torch.sum(m_v * m_v) - m
                - torch.sum(torch.log(torch.diagonal(Lv) ** 2)))
    return -(exp_ll - kl) / n


def _adam_minimise(loss_fn, params: dict, max_iters: int, lr: float
                   ) -> dict:
    """optax.adam on a dict of tensors, stopping after the iteration at
    which more than 1000 iterations have run and the last ten loss
    deltas sum to ~0 (the reference's plateau test, GPI.py:695-698)."""
    names = list(params)
    p = dict(params)
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    x0 = next(iter(p.values()))
    buf = torch.zeros(11, dtype=x0.dtype, device=x0.device)
    for it in range(max_iters):
        tp = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = loss_fn(tp)
        grads = torch.autograd.grad(loss, [tp[k] for k in names])
        bc1, bc2 = 1.0 - _B1 ** (it + 1), 1.0 - _B2 ** (it + 1)
        for k, g in zip(names, grads):
            p[k], mu[k], nu[k] = adam_update(p[k], g, mu[k], nu[k], lr,
                                             bc1, bc2)
        buf = torch.cat([buf[1:], loss.detach()[None]])
        if it > 1000 and bool(
                torch.abs(torch.sum(buf[1:] - buf[:-1])) < 1e-4):
            break
    return p


def _inducing_fit(nll, extra, x_basis, y, bound_sigma, max_iters, lr,
                  dtype, device):
    device = resolve_device(device)
    x = torch.as_tensor(np.array(x_basis), dtype=dtype,
                        device=device).reshape(-1)
    y = torch.as_tensor(np.array(y), dtype=dtype, device=device).reshape(-1)
    lb = torch.tensor(bound_sigma[0], dtype=dtype, device=device)
    ub = torch.tensor(bound_sigma[1], dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    params = {"raw_s": zero, "raw_l": zero, "raw_n": zero, "c": zero,
              "Z": x.clone(), **extra(x)}
    p = _adam_minimise(lambda t: nll(t, lb, ub, x, y), params,
                       max_iters, lr)
    theta = KernelParams(
        outputscale=_softplus(p["raw_s"]),
        lengthscale=torch.clamp(_softplus(p["raw_l"]), min=1e-6),
        noise=_interval(p["raw_n"], lb, ub))
    return theta, torch.sort(p["Z"]).values


def fit_kernel_sgpr(x_basis, y, bound_sigma: Tuple[float, float],
                    max_iters: int = 5000, lr: float = 0.1,
                    dtype=torch.float64, device=DEFAULT_DEVICE):
    """Inducing-point (SGPR) kernel fit on one beat. Returns
    (KernelParams, Z_sorted): the LEARNED lengthscale (the reference
    pins it only on the exact path, GPI.py:706-714 vs :715-740) and the
    sorted learned inducing locations (GPI.py:718-733)."""
    return _inducing_fit(_sgpr_nll, lambda x: {}, x_basis, y, bound_sigma,
                         max_iters, lr, dtype, device)


def fit_kernel_svgp(x_basis, y, bound_sigma: Tuple[float, float],
                    max_iters: int = 5000, lr: float = 0.1,
                    dtype=torch.float64, device=DEFAULT_DEVICE):
    """Variational (SVGP) kernel fit, the VarProjectedGPModel path
    (GPI_models_pytorch.py:37-46; write-back GPI.py:740-752). Returns
    (KernelParams, Z_sorted) like ``fit_kernel_sgpr``; q(v) starts at
    m_v = 0 and a diagonal scale of softplus(0.5413) ~ 1."""
    m = np.asarray(x_basis).reshape(-1).shape[0]

    def extra(x):
        return {"m_v": torch.zeros(m, dtype=x.dtype, device=x.device),
                "L_raw": torch.eye(m, dtype=x.dtype, device=x.device)
                * 0.5413}
    return _inducing_fit(_svgp_nelbo, extra, x_basis, y, bound_sigma,
                         max_iters, lr, dtype, device)


def fit_kernel_scipy(x_basis, y, bound_sigma,
                     bounds_lengthscale=(1.0, 20.0),
                     bounds_outputscale=(1e-2, 1e3), n_restarts: int = 0,
                     seed: int = 0, dtype=torch.float64,
                     device=DEFAULT_DEVICE) -> KernelParams:
    """L-BFGS-B marginal-likelihood fit in log-theta space on the host
    (the reference's legacy scipy path, GPI.fit / _constrained_
    optimization, GPI.py:772-876, :1114-1132), with optional random
    restarts; the result as tensors on ``device``."""
    import scipy.optimize

    device = resolve_device(device)
    x = np.asarray(x_basis, np.float64).reshape(-1)
    yv = np.asarray(y, np.float64).reshape(-1)
    T = x.shape[0]
    d2 = (x[:, None] - x[None, :]) ** 2

    def nll(log_theta):
        s, lsc, n = np.exp(log_theta)
        K = s * np.exp(-0.5 * d2 / (lsc * lsc)) + n * np.eye(T)
        try:
            L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            return np.inf
        a = np.linalg.solve(L, yv)
        return float(0.5 * a @ a + np.sum(np.log(np.diag(L)))
                     + 0.5 * T * np.log(2 * np.pi))

    bounds = [np.log(bounds_outputscale), np.log(bounds_lengthscale),
              np.log(bound_sigma)]
    inits = [np.array([np.log(1.0), np.log(3.0),
                       np.log(np.sqrt(bound_sigma[0] * bound_sigma[1]))])]
    rng = np.random.default_rng(seed)
    for _ in range(n_restarts):
        inits.append(np.array([rng.uniform(*b) for b in bounds]))
    best = None
    for x0 in inits:
        r = scipy.optimize.minimize(nll, x0, method="L-BFGS-B",
                                    bounds=bounds,
                                    options={"maxiter": 50000})
        if best is None or r.fun < best.fun:
            best = r
    return KernelParams(*[torch.tensor(v, dtype=dtype, device=device)
                          for v in np.exp(best.x)])


# ---------------------------------------------------------------------------
# GP model zoo registry (reference: GPI_models_pytorch.py;
# kernel_fit.py:478-554). Every kernel-fit mode a user of the reference
# could reach is implemented here or fails LOUDLY with the reason: the
# LinearExactGPModel and AlignmentGPModel fits serve only the reference's
# legacy warping_system.py (superseded by the monotone warp), and
# AlignGPModel and GPMean are dead code there.
# ---------------------------------------------------------------------------

def _legacy_warp_only(name: str, ref_lines: str, dead_code: bool = False):
    def _raise(*_a, **_k):
        if dead_code:
            raise NotImplementedError(
                f"{name} ({ref_lines}) is dead code in the reference — "
                "defined in GPI_models_pytorch.py but consumed by nothing. "
                "hdpgpc_torch deliberately does not mirror it.")
        raise NotImplementedError(
            f"{name} ({ref_lines}) is only consumed by the reference's "
            "legacy warping_system.py, which hdpgpc_torch deliberately "
            "does not mirror (superseded by the monotone warp — use "
            "hdpgpc_torch.warp.monotone / with_warp=True). If you need "
            "the legacy warp, run the reference implementation.")
    _raise.__name__ = f"fit_{name}"
    return _raise


GP_MODEL_ZOO = {
    # reference class -> the port's fit path
    "ExactGPModel": fit_kernel,                      # GPI_models_pytorch.py:10-22
    "ProjectedGPModel": fit_kernel_sgpr,             # :24-35 (SGPR collapsed bound)
    "VarProjectedGPModel": fit_kernel_svgp,          # :37-46 (SVGP / uncollapsed)
    "LinearExactGPModel": _legacy_warp_only(
        "LinearExactGPModel", "GPI_models_pytorch.py:48-60"),
    "AlignmentGPModel": _legacy_warp_only(
        "AlignmentGPModel", "GPI_models_pytorch.py:63-88"),
    "AlignGPModel": _legacy_warp_only(
        "AlignGPModel", "GPI_models_pytorch.py:89-114", dead_code=True),
    "GPMean": _legacy_warp_only(
        "GPMean", "GPI_models_pytorch.py:115-131", dead_code=True),
}


def fit_kernel_zoo(model_name: str, *args, **kwargs):
    """Dispatch a kernel fit by the reference's model-zoo class name.
    ``ExactGPModel`` returns ``KernelParams``; ``ProjectedGPModel`` and
    ``VarProjectedGPModel`` return ``(KernelParams, Z)``; the fenced
    entries raise NotImplementedError with the reason, and an unknown
    name raises KeyError listing the zoo."""
    try:
        fn = GP_MODEL_ZOO[model_name]
    except KeyError:
        raise KeyError(
            f"unknown GP zoo model {model_name!r}; known: "
            f"{sorted(GP_MODEL_ZOO)}") from None
    return fn(*args, **kwargs)
