"""Monotone time-warp alignment, batched (counterpart of
hdpgpc_tpu.warp.monotone; reference amtgp_warping_system.py).

* a warp g(t) is parameterised by ``n_ctrl`` unconstrained control
  values, linearly interpolated to T points, passed through softplus to
  positive increments, cumulatively summed and renormalised to
  [x_min, x_max] (amtgp:328-357, :665-683): monotone by construction;
* the MAP objective is 0.5 * SSE / noise + lam_s * ||D2 w||^2 +
  lam_a * ||w||^2, with (lam_s, lam_a) mapped from the GP kernel theta
  (amtgp:367-397, :456-488);
* optimisation is Adam with a FIXED iteration count (the reference has
  no early stop in the warp loop), the loss the MEAN over the batch,
  gradients from ``torch.autograd.grad``;
* the warp-prior scorer is the full GP log-density of the warp offsets
  under an RBF + noise prior on the normalised grid, with a cached
  Cholesky (WarpPriorAMTGP, amtgp:106-264).

The Choleskys and solves here are ``torch.linalg`` (they were XLA, not a
Pallas kernel, in the reference). Callers pass float64 tensors: the warp
runs in float64 whatever the model's compute dtype, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from hdpgpc_torch.models.kernel_fit import _B1, _B2, adam_update
from hdpgpc_torch.ops import linalg


class WarpResult(NamedTuple):
    x_warp: torch.Tensor    # (B, T) warp offsets g - x
    y_warp: torch.Tensor    # (B, T) warped target signals
    lik: torch.Tensor       # (B,) GP-prior log density of the warps
    lik_data: torch.Tensor  # (B,) MAP data log-lik of warped y under the
    #                         template: -0.5(sse/n + T log 2πn) - penalties
    #                         (compute_warp's lik_warp, amtgp:495-507)


class WarpPrior(NamedTuple):
    """Precomputed warp-prior factorisation for one grid."""
    L: torch.Tensor         # (T, T) Cholesky of the prior covariance
    logdet: torch.Tensor


def make_warp_prior(x: torch.Tensor, noise_warp: float,
                    bound_noise_warp: Tuple[float, float],
                    rho: float = 1.0, omega: float = 1.0,
                    jitter: float = 1e-6) -> WarpPrior:
    """K = omega^2 exp(-0.5 (dx/rho)^2) + (noise + jitter) I on the
    x-grid normalised to [0, 1] (amtgp:160-173)."""
    x = x.reshape(-1)
    lo, hi = bound_noise_warp
    n = torch.clamp(torch.as_tensor(noise_warp, dtype=x.dtype,
                                    device=x.device), lo, hi)
    xr = x - x[0]
    rng = torch.abs(xr[-1] - xr[0]) + 1e-12
    xu = xr / rng
    dx = xu[:, None] - xu[None, :]
    K = (omega * omega) * torch.exp(-0.5 * (dx * dx) / (rho * rho))
    K = K + (n + jitter) * torch.eye(x.shape[0], dtype=x.dtype,
                                     device=x.device)
    L = torch.linalg.cholesky(K)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return WarpPrior(L=L, logdet=logdet)


def warp_prior_score(prior: WarpPrior, x_warp: torch.Tensor) -> torch.Tensor:
    """Full GP log density of warp offsets (B, T) -> (B,)
    (WarpPriorAMTGP.log_sq_error_batch, amtgp:224-264)."""
    W = torch.atleast_2d(x_warp)
    T = W.shape[1]
    alpha = linalg.cho_solve(prior.L, W.T)                 # (T, B)
    quad = torch.sum(W.T * alpha, dim=0)
    const = T * math.log(2.0 * math.pi)
    return -0.5 * (quad + prior.logdet + const)


# XLA's CPU cumsum (the reference's) is blocked: a sequential sum within
# blocks of 16, then the blocks' totals; its transpose (the reverse
# cumsum) sums each window left to right. A warp of the template beat
# against itself starts on a residual that is all rounding (~1e-13), and
# Adam scales that noise up to a real step, so the port sums in the
# reference's order, on every device, in both directions.
_CUMSUM_BLOCK = 16


def _blocked(x: torch.Tensor):
    B, T = x.shape
    nb = -(-T // _CUMSUM_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _CUMSUM_BLOCK - T))
    return xp.reshape(B, nb, _CUMSUM_BLOCK), nb


def _cumsum_fwd(x: torch.Tensor) -> torch.Tensor:
    T = x.shape[1]
    xb, nb = _blocked(x)
    cols = [xb[..., 0]]
    for d in range(1, _CUMSUM_BLOCK):
        cols.append(cols[-1] + xb[..., d])
    inner = torch.stack(cols, -1)
    tot = inner[..., -1]
    offs = [torch.zeros_like(tot[:, 0])]
    for j in range(1, nb):
        offs.append(tot[:, 0] if j == 1 else offs[-1] + tot[:, j - 1])
    out = inner + torch.stack(offs, 1)[..., None]
    return out.reshape(x.shape[0], -1)[:, :T]


def _cumsum_rev(x: torch.Tensor) -> torch.Tensor:
    T = x.shape[1]
    xb, nb = _blocked(x)
    xz = torch.nn.functional.pad(xb, (0, _CUMSUM_BLOCK - 1))
    acc = xz[..., :_CUMSUM_BLOCK]
    for d in range(1, _CUMSUM_BLOCK):
        acc = acc + xz[..., d:d + _CUMSUM_BLOCK]
    tot = acc[..., 0]
    offs = []
    for j in range(nb):
        s = torch.zeros_like(tot[:, 0])
        for k in range(j + 1, nb):
            s = tot[:, k] if k == j + 1 else s + tot[:, k]
        offs.append(s)
    out = acc + torch.stack(offs, 1)[..., None]
    return out.reshape(x.shape[0], -1)[:, :T]


class _Cumsum(torch.autograd.Function):
    """Row cumsum of a (B, T) tensor in XLA's summation order."""

    @staticmethod
    def forward(ctx, x):
        return _cumsum_fwd(x)

    @staticmethod
    def backward(ctx, g):
        return _cumsum_rev(g)


def _theta_to_lambdas(theta_rho, theta_omega, lam_s_base, lam_a_base):
    lam_s = lam_s_base / (theta_rho * theta_rho + 1e-12)
    lam_a = lam_a_base / (theta_omega * theta_omega + 1e-12)
    return lam_s, lam_a


def _interp_ctrl_to_T(u_ctrl: torch.Tensor, T: int) -> torch.Tensor:
    """Linear interpolation of (B, n_ctrl) control values onto T points
    (F.interpolate(mode='linear', align_corners=True) semantics). The
    positions are ``jnp.linspace(0, n_ctrl - 1, T)`` to the last bit:
    stop * (i / (T - 1)), then the stop itself."""
    B, n_ctrl = u_ctrl.shape
    dt, dev = u_ctrl.dtype, u_ctrl.device
    stop = n_ctrl - 1.0
    step = torch.arange(T - 1, dtype=dt, device=dev) / (T - 1)
    pos = torch.cat([stop * step, torch.full((1,), stop, dtype=dt,
                                             device=dev)])
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n_ctrl - 2)
    w = pos - i0
    return (1.0 - w)[None, :] * u_ctrl[:, i0] + w[None, :] * u_ctrl[:, i0 + 1]


def _interp_signal(x: torch.Tensor, Y: torch.Tensor,
                   Xq: torch.Tensor) -> torch.Tensor:
    """Batched linear interpolation: x (T,), Y (B, T), Xq (B, T) -> (B, T)
    (amtgp lin_interp_batch, :639-663). The clip is maximum-then-minimum,
    as ``jnp.clip`` is: at a tie (grid column 0 sits on x[0]) both split
    the gradient in half, where ``torch.clamp`` passes all of it."""
    Xq = torch.minimum(torch.maximum(Xq, x[0]), x[-1])
    idx_hi = torch.clamp(torch.searchsorted(x, Xq.detach(), right=False),
                         1, x.shape[0] - 1)
    idx_lo = idx_hi - 1
    x_lo = x[idx_lo]
    x_hi = x[idx_hi]
    y_lo = torch.gather(Y, 1, idx_lo)
    y_hi = torch.gather(Y, 1, idx_hi)
    t = (Xq - x_lo) / (x_hi - x_lo + 1e-12)
    return (1.0 - t) * y_lo + t * y_hi


def build_batch_warp(T: int, n_ctrl: int = 8, lr: float = 5e-2,
                     lam_s_base: float = 200.0, lam_a_base: float = 1e-3,
                     train_iter: int = 50):
    """Build the batched warp optimiser for beat length T.

    Returns warp(x (T,), Y_target (B, T), y_model (T,), prior: WarpPrior,
                 theta_rho, theta_omega, noise) -> WarpResult,
    computed on the device and in the dtype of ``Y_target``.
    """
    n_ctrl = max(4, min(n_ctrl, T))

    def monotone_grid(u_ctrl, x):
        uT = _interp_ctrl_to_T(u_ctrl, T)
        # jax.nn.softplus is logaddexp(x, 0); torch's softplus turns
        # linear above 20
        inc = torch.logaddexp(uT, torch.zeros_like(uT)) + 1e-6
        g_raw = _Cumsum.apply(inc)
        x_min, x_max = x[0], x[-1]
        g = (g_raw - g_raw[:, :1]) / (g_raw[:, -1:] - g_raw[:, :1] + 1e-12)
        g = x_min + (x_max - x_min) * g
        return g, g - x[None, :]

    def warp(x, Y_target, y_model, prior: WarpPrior, theta_rho, theta_omega,
             noise) -> WarpResult:
        # ``noise`` is the already-reduced-and-clamped scalar n: the
        # reference reduces diag(cov) -> scalar BEFORE the optimiser
        # (noise[0] online via _safe_noise amtgp:44-57; mean() batch via
        # amtgp:611-617), both clamped into bound_noise_warp; callers
        # replicate that reduction
        B = Y_target.shape[0]
        dt, dev = Y_target.dtype, Y_target.device
        x = x.to(dt)
        y_model = y_model.to(dt)

        def scalar(v):
            return torch.as_tensor(v, dtype=dt, device=dev).reshape(())
        lam_s, lam_a = _theta_to_lambdas(scalar(theta_rho),
                                         scalar(theta_omega),
                                         lam_s_base, lam_a_base)
        n = torch.clamp(scalar(noise), min=1e-12)

        def penalties(xw):
            d2 = xw[:, :-2] - 2.0 * xw[:, 1:-1] + xw[:, 2:]
            return torch.sum(d2 * d2, dim=1), torch.sum(xw * xw, dim=1)

        def loss_fn(u_ctrl):
            g, xw = monotone_grid(u_ctrl, x)
            Yw = _interp_signal(x, Y_target, g)
            resid = Yw - y_model[None, :]
            sse = torch.sum(resid * resid, dim=1)
            sp, ap = penalties(xw)
            per = 0.5 * sse / (n + 1e-12) + lam_s * sp + lam_a * ap
            return torch.mean(per)

        u = torch.zeros((B, n_ctrl), dtype=dt, device=dev)
        mu = torch.zeros_like(u)
        nu = torch.zeros_like(u)
        for count in range(1, train_iter + 1):
            ur = u.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(ur), ur)
            u, mu, nu = adam_update(u, g, mu, nu, lr, 1.0 - _B1 ** count,
                                    1.0 - _B2 ** count)
        with torch.no_grad():
            g, xw = monotone_grid(u, x)
            Yw = _interp_signal(x, Y_target, g)
            lik = warp_prior_score(prior, xw)
            # MAP data log-lik of the final warp (amtgp:495-507, bayesian
            # branch: penalties enter as log-priors)
            resid = Yw - y_model[None, :]
            sse = torch.sum(resid * resid, dim=1)
            ll = -0.5 * (sse / (n + 1e-12)
                         + Yw.shape[1] * torch.log(2.0 * math.pi
                                                   * (n + 1e-12)))
            sp, ap = penalties(xw)
            ll = ll - (lam_s * sp + lam_a * ap)
        return WarpResult(x_warp=xw, y_warp=Yw, lik=lik, lik_data=ll)

    return warp
