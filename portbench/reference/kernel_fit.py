"""Plain kernel-hyperparameter fit (float64, or the caller's dtype):
Adam on the exact GP marginal likelihood of one beat under Constant *
RBF + White with a constant mean, softplus for the outputscale and
lengthscale, an interval sigmoid for the noise, each lane stopping at
its own plateau once more than 1000 iterations have run (the model's
fit, written plainly: one Cholesky of ``torch.linalg`` a lane and
iteration)."""

from __future__ import annotations

import math

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def nll(raw_s, raw_l, raw_n, c, n_lb, n_ub, x, y):
    """Negative mean log marginal likelihood per lane."""
    s = softplus(raw_s)[:, None, None]
    lsc = torch.clamp(softplus(raw_l), min=1e-6)[:, None, None]
    n = (n_lb + (n_ub - n_lb) * torch.sigmoid(raw_n))[:, None, None]
    T = x.shape[0]
    d2 = (x[:, None] - x[None, :]) ** 2
    K = s * torch.exp(-torch.clamp(0.5 * d2 / lsc ** 2, max=700.0)) \
        + n * torch.eye(T, dtype=x.dtype, device=x.device)
    L = torch.linalg.cholesky(K)
    r = (y - c[:, None])[..., None]
    alpha = torch.cholesky_solve(r, L)
    ll = (-0.5 * torch.sum(r * alpha, dim=(-2, -1))
          - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
          - 0.5 * T * math.log(2.0 * math.pi))
    return -ll / T


def fit(x, Ys, n_lb: float, n_ub: float, max_iters: int, lr: float):
    """Ys (B, T) seed beats on grid x (T,) -> (outputscale (B,),
    noise (B,)), in x's dtype."""
    dt = x.dtype
    Ys = Ys.to(dt)
    B = Ys.shape[0]
    lb = torch.tensor(n_lb, dtype=dt, device=x.device)
    ub = torch.tensor(n_ub, dtype=dt, device=x.device)
    params = [torch.zeros(B, dtype=dt, device=x.device) for _ in range(4)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    count = torch.zeros(B, dtype=dt, device=x.device)
    buf = torch.zeros((B, 11), dtype=dt, device=x.device)
    done = torch.zeros(B, dtype=torch.bool, device=x.device)
    for it in range(max_iters):
        tp = [p.detach().requires_grad_(True) for p in params]
        loss = nll(*tp, lb, ub, x, Ys)
        grads = torch.autograd.grad(loss.sum(), tp)
        loss = loss.detach()
        active = ~done
        cnt = count + 1
        bc1 = 1 - B1 ** cnt
        bc2 = 1 - B2 ** cnt
        for k, g in enumerate(grads):
            m = (1 - B1) * g + B1 * mu[k]
            v = (1 - B2) * g ** 2 + B2 * nu[k]
            upd = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            params[k] = torch.where(active, params[k] - lr * upd, params[k])
            mu[k] = torch.where(active, m, mu[k])
            nu[k] = torch.where(active, v, nu[k])
        count = torch.where(active, cnt, count)
        buf = torch.where(active[:, None],
                          torch.cat([buf[:, 1:], loss[:, None]], 1), buf)
        if it > 1000:
            plateau = torch.abs(torch.sum(buf[:, 1:] - buf[:, :-1], 1)) \
                < 1e-4
            done = done | (active & plateau)
            if bool(done.all()):
                break
    raw_s, _raw_l, raw_n, _c = params
    return softplus(raw_s), lb + (ub - lb) * torch.sigmoid(raw_n)
