"""ops.scan.associative_scan against jax.lax.associative_scan, and the
Kalman / MNIW primitives against hdpgpc_tpu, float64 on the CPU.
Tolerance: 1e-12 relative (round-off of a few dozen (T, T) products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch.models import mniw as tm
from hdpgpc_torch.ops import kalman as tk
from hdpgpc_torch.ops.scan import associative_scan
from hdpgpc_tpu.models import mniw as jm
from hdpgpc_tpu.ops import kalman as jk

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _spd(rng, T, d=1.0):
    M = rng.standard_normal((T, T)) / np.sqrt(T)
    return M @ M.T + d * np.eye(T)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_jax(n, reverse):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, 5, 5)) / np.sqrt(5)
    b = rng.standard_normal((n, 5, 1))

    def affine(l, r):                    # x -> A x + b composition
        return (r[0] @ l[0], r[0] @ l[1] + r[1])

    ja = jax.lax.associative_scan(affine, (jnp.asarray(A), jnp.asarray(b)),
                                  reverse=reverse)
    ta = associative_scan(affine, (torch.tensor(A), torch.tensor(b)),
                          reverse=reverse)
    for x, y in zip(ta, ja):
        assert _rel(x.numpy(), y) < 1e-12
    # single-tensor form
    js = jax.lax.associative_scan(jnp.add, jnp.asarray(b), reverse=reverse)
    ts = associative_scan(torch.add, torch.tensor(b), reverse=reverse)
    assert _rel(ts.numpy(), js) < 1e-12


@pytest.mark.parametrize("first", [True, False])
def test_kalman_step_matches_jax(first):
    rng = np.random.default_rng(4)
    T = 12
    f = rng.standard_normal((T, 1))
    P, G, S = _spd(rng, T), _spd(rng, T, 0.1), _spd(rng, T, 0.3)
    A = np.eye(T) + 0.05 * rng.standard_normal((T, T))
    C = np.eye(T) + 0.05 * rng.standard_normal((T, T))
    y = rng.standard_normal((T, 1))
    fj, Pj = jk.kalman_step(*map(jnp.asarray, (f, P, y)),
                            jk.LDSParams(*map(jnp.asarray, (A, G, C, S))),
                            jnp.asarray(first), noise_first=0.05, h=1.0)
    ft, Pt = tk.kalman_step(*map(torch.tensor, (f, P, y)),
                            tk.LDSParams(*map(torch.tensor, (A, G, C, S))),
                            torch.tensor(first), noise_first=0.05, h=1.0)
    assert _rel(ft.numpy(), fj) < 1e-12 and _rel(Pt.numpy(), Pj) < 1e-12


def test_rts_pair_and_smooth_match_jax():
    rng = np.random.default_rng(5)
    T, N = 10, 6
    means = rng.standard_normal((N, T, 1))
    covs = np.stack([_spd(rng, T) for _ in range(N)])
    A = np.stack([np.eye(T) + 0.05 * rng.standard_normal((T, T))
                  for _ in range(N)])
    G = np.stack([_spd(rng, T, 0.2) for _ in range(N)])
    pj = jk.rts_pair(*map(jnp.asarray, (means[0], covs[0], means[1],
                                        covs[1], A[0], G[0])))
    pt = tk.rts_pair(*map(torch.tensor, (means[0], covs[0], means[1],
                                         covs[1], A[0], G[0])))
    for x, y in zip(pt, pj):
        assert _rel(x.numpy(), y) < 1e-12
    sj = jk.rts_smooth(*map(jnp.asarray, (A, G, means, covs)))
    st = tk.rts_smooth(*map(torch.tensor, (A, G, means, covs)))
    for x, y in zip(st, sj):
        assert _rel(x.numpy(), y) < 1e-12


@pytest.mark.parametrize("n_k", [1, 3])
def test_mniw_posterior_and_likelihood_match_jax(n_k):
    rng = np.random.default_rng(6 + n_k)
    T = 8
    mean = np.eye(T) + 0.1 * rng.standard_normal((T, T))
    scale = _spd(rng, T, 0.5)
    y1 = rng.standard_normal((T, n_k))
    y2 = rng.standard_normal((T, n_k))
    cov, cov_, cross = _spd(rng, T), _spd(rng, T), 0.1 * _spd(rng, T)
    pj = jm.posterior(jm.make_mniw(jnp.asarray(mean), 5.0,
                                   jnp.asarray(scale)), n_k,
                      *map(jnp.asarray, (y1, y2, cov, cov_, cross)))
    pt = tm.posterior(tm.make_mniw(torch.tensor(mean), 5.0,
                                   torch.tensor(scale)), n_k,
                      *map(torch.tensor, (y1, y2, cov, cov_, cross)))
    for f in ("mean", "row_cov", "n0", "scale"):
        assert _rel(getattr(pt, f).numpy(), getattr(pj, f)) < 1e-12, f
    M, Sig = mean + 0.01, _spd(rng, T, 0.7)
    lj = jm.log_likelihood(pj, jnp.asarray(M), jnp.asarray(Sig))
    lt = tm.log_likelihood(pt, torch.tensor(M), torch.tensor(Sig))
    assert _rel(lt.numpy(), lj) < 1e-12
    gj = jm.get_scale(pj)
    gt = tm.get_scale(pt)
    assert _rel(gt.numpy(), gj) < 1e-12
