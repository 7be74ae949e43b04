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
``torch.linalg``. The SGPR / SVGP inducing-point fits are not ported
yet (ROADMAP A11).
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


def _nll(raw_s, raw_l, raw_n, c, n_lb, n_ub, x, y):
    """Negative mean log marginal likelihood per lane: raw params (B,),
    x (T,), y (B, T) -> (B,)."""
    s = _softplus(raw_s)[:, None, None]
    # floor inert on sane trajectories; engages only if Adam diverges
    lsc = torch.clamp(_softplus(raw_l), min=1e-6)[:, None, None]
    n = (n_lb + (n_ub - n_lb) * torch.sigmoid(raw_n))[:, None, None]
    T = x.shape[0]
    d2 = (x[:, None] - x[None, :]) ** 2
    K = (s * torch.exp(-torch.clamp(0.5 * d2 / (lsc ** 2), max=700.0))
         + n * torch.eye(T, dtype=x.dtype, device=x.device))
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
    return _softplus(raw_s), n_lb + (n_ub - n_lb) * torch.sigmoid(raw_n)


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
