"""The port's linear algebra and the plain versions of its two kernels
against hdpgpc_tpu, on the CPU (the wrappers take the plain version for
CPU tensors). Tolerances: float64 round-off of O(T) operations."""

import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from hdpgpc_torch.ops import linalg as tl
from hdpgpc_torch.ops import kernels as tk
from hdpgpc_torch.ops.spd_solve import (spd_solve, spd_solve_blocked_plain,
                                        spd_solve_plain)
from hdpgpc_tpu.ops import kernels as jk
from hdpgpc_tpu.ops import linalg as jl

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)


def _spd(rng, n, T, cond=0.05, scale=37.0):
    M = rng.standard_normal((n, T, T))
    return (M @ M.transpose(0, 2, 1) + cond * np.eye(T)) * scale


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("fn", ["chol_spd", "logdet_spd", "inv_spd",
                                "gaussian_score", "solve_spd_t",
                                "spd_solve", "gaussian_score_shared_cov"])
def test_linalg_matches_jax(fn):
    rng = np.random.default_rng(0)
    T = 20
    S = _spd(rng, 1, T, cond=1.0, scale=1.0)[0]
    B = rng.standard_normal((T, 7))
    y = rng.standard_normal(T)
    Y = rng.standard_normal((5, T))
    t = lambda a: torch.tensor(a)
    j = jnp.asarray
    if fn == "chol_spd":
        a, b = tl.chol_spd(t(S)), jl.chol_spd(j(S))
    elif fn == "logdet_spd":
        a, b = tl.logdet_spd(t(S)), jl.logdet_spd(j(S))
    elif fn == "inv_spd":
        a, b = tl.inv_spd(t(S)), jl.inv_spd(j(S))
    elif fn == "gaussian_score":
        a, b = tl.gaussian_score(t(y), t(S)), jl.gaussian_score(j(y), j(S))
    elif fn == "solve_spd_t":
        a, b = tl.solve_spd_t(t(S), t(B.T)), jl.solve_spd_t(j(S), j(B.T))
    elif fn == "spd_solve":
        a, b = tl.spd_solve(t(S), t(B)), jl.spd_solve(j(S), j(B))
    else:
        a = tl.gaussian_score_shared_cov(t(Y), t(y), t(S))
        b = jl.gaussian_score_shared_cov(j(Y), j(y), j(S))
    assert _rel(a.numpy(), b) < 1e-12


def test_chol_nan_on_failure_and_symmetrises():
    """jnp.linalg.cholesky semantics: symmetrised input, NaN on failure."""
    rng = np.random.default_rng(1)
    S = _spd(rng, 2, 6, cond=1.0, scale=1.0)
    S[1] = -S[1]                              # not positive definite
    A = S.copy()
    A[0] += np.triu(rng.standard_normal((6, 6)), 1)  # asymmetric upper
    L = tl.chol(torch.tensor(A)).numpy()
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    low = np.tril(np.ones((6, 6), bool))
    assert np.isnan(L[1][low]).all() and np.isnan(Lj[1][low]).all()
    np.testing.assert_array_equal(L[1][~low], Lj[1][~low])
    np.testing.assert_allclose(L[0], Lj[0], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("T", [24, 90, 256])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gram_matches_jax(T, dtype):
    """gram/rbf_gram/fused_rbf_gram (plain on the CPU) vs JAX; float64
    relative error <= 1e-13, float32 <= 1e-6."""
    x = np.arange(T, dtype=np.float64)
    th = (300.0, 1.2, 0.05)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    Kj = np.asarray(jk.gram(jk.KernelParams(*[jnp.asarray(v, jdt)
                                              for v in th]),
                            jnp.asarray(x, jdt), jnp.asarray(x, jdt)))
    p = tk.KernelParams(*[torch.tensor(v, dtype=dtype) for v in th])
    xt = torch.tensor(x, dtype=dtype)
    Kt = tk.gram(p, xt, xt).numpy()
    Kf = tk.fused_rbf_gram(xt, xt, p.outputscale, p.lengthscale).numpy()
    bar = 1e-13 if dtype == torch.float64 else 1e-6
    floor = 1e-30 * 300.0
    for K in (Kt, Kf):
        assert np.max(np.abs(K - Kj) / (np.abs(Kj) + floor)) <= bar
    # sklearn semantics: one-argument adds the noise on the diagonal
    Kn = tk.gram(p, xt).numpy()
    np.testing.assert_allclose(np.diag(Kn) - np.diag(Kt), 0.05,
                               rtol=1e-3)


def test_spd_solve_plain_matches_jax_cho_solve():
    """Kernel B's plain version at the refit's main-path shape
    (16, 90, 90), float64, against JAX cholesky + cho_solve, on the
    well-conditioned Kalman-magnitude systems (diagonal 5.0, as in
    tests/test_pallas_chol.py:29-47; at a diagonal of 0.05 two float64
    Cholesky solves already differ by ~1e-10 relative)."""
    rng = np.random.default_rng(2)
    spd = _spd(rng, 16, 90, cond=5.0)
    rhs = rng.standard_normal((16, 90, 90)) * 12.0
    L = jnp.linalg.cholesky(jnp.asarray(spd))
    Xj = np.asarray(jnp.stack([jsl.cho_solve((L[i], True),
                                             jnp.asarray(rhs[i]))
                               for i in range(16)]))
    Xt = spd_solve(torch.tensor(spd), torch.tensor(rhs)).numpy()
    assert np.max(np.abs(Xt - Xj) / (np.abs(Xj) + 1e-3)) < 1e-10
    bad = spd.copy()
    bad[3] = -bad[3]
    Xb = spd_solve_plain(torch.tensor(bad), torch.tensor(rhs)).numpy()
    assert np.isnan(Xb[3]).all() and np.isfinite(np.delete(Xb, 3, 0)).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gram_noise_fused_matches_jax(dtype):
    """Kernel A's plain version with the noise in the same call equals
    the one-argument JAX gram (noise on the diagonal) and the port's
    gram, which routes through it."""
    T = 90
    x = np.arange(T, dtype=np.float64)
    th = (300.0, 1.2, 0.05)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    Kj = np.asarray(jk.gram(jk.KernelParams(*[jnp.asarray(v, jdt)
                                              for v in th]),
                            jnp.asarray(x, jdt)))
    p = tk.KernelParams(*[torch.tensor(v, dtype=dtype) for v in th])
    xt = torch.tensor(x, dtype=dtype)
    Kf = tk.fused_rbf_gram(xt, xt, *p).numpy()
    np.testing.assert_array_equal(Kf, tk.gram(p, xt).numpy())
    bar = 1e-13 if dtype == torch.float64 else 1e-6
    assert np.max(np.abs(Kf - Kj) / (np.abs(Kj) + 1e-30 * 300.0)) <= bar


@pytest.mark.parametrize("T", [5, 33, 90, 128, 200])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-3)])
def test_spd_solve_blocked_plain_matches_jax(T, dtype, bar):
    """Kernel B's algorithm, step by step in torch (panels of 32,
    identity padding, inverted diagonal blocks, blocked substitutions),
    against JAX cholesky + cho_solve in float64 on the same (rounded)
    inputs: max |X - X_j| / (|X_j| + 1e-3) <= 1e-10 in float64, 2e-3 in
    float32, on the well-conditioned Kalman-magnitude systems (diagonal
    5.0) of tests/test_pallas_chol.py:29-47; NaN over a system whose
    factorisation fails."""
    rng = np.random.default_rng(T)
    n = 4 if T < 128 else 2
    spd = _spd(rng, n, T, cond=5.0)
    rhs = rng.standard_normal((n, T, T)) * 12.0
    spd[1] = -spd[1]
    a = torch.tensor(spd, dtype=dtype)
    b = torch.tensor(rhs, dtype=dtype)
    X = spd_solve_blocked_plain(a, b).double().numpy()
    A64, B64 = a.double().numpy(), b.double().numpy()
    L = jnp.linalg.cholesky(jnp.asarray(A64))
    Xj = np.asarray(jnp.stack([jsl.cho_solve((L[i], True),
                                             jnp.asarray(B64[i]))
                               for i in range(n)]))
    assert np.isnan(X[1]).all()
    good = [i for i in range(n) if i != 1]
    err = np.max(np.abs(X[good] - Xj[good]) / (np.abs(Xj[good]) + 1e-3))
    assert err <= bar, err


def test_spd_solve_wrapper_rejects_mixed_devices():
    a = torch.eye(3, dtype=torch.float64)[None]
    with pytest.raises(ValueError):
        spd_solve(a, torch.empty((1, 3, 3), device="meta",
                                 dtype=torch.float64))


@pytest.mark.slow
@pytest.mark.pallas
def test_spd_solve_plain_vs_pallas_interpret():
    """Against the Pallas kernel itself in interpret mode (float32; about
    a minute per call on a CPU, hence slow, as tests/test_pallas_chol.py)."""
    from hdpgpc_tpu.ops.pallas.chol_solve import fused_spd_solve
    rng = np.random.default_rng(3)
    spd = _spd(rng, 4, 90, cond=5.0).astype(np.float32)
    rhs = (rng.standard_normal((4, 90, 90)) * 12.0).astype(np.float32)
    Xp = np.asarray(fused_spd_solve(jnp.asarray(spd), jnp.asarray(rhs),
                                    interpret=True))
    Xt = spd_solve(torch.tensor(spd), torch.tensor(rhs)).numpy()
    truth = np.linalg.solve(spd.astype(np.float64), rhs.astype(np.float64))
    for X in (Xp, Xt):
        assert np.max(np.abs(X - truth) / (np.abs(truth) + 1e-3)) < 2e-3
