"""The associative-scan Kalman forms of the port (ops/kalman.py:
parallel_filter, parallel_filter_masked, parallel_smooth) against
hdpgpc_tpu's and against the port's own sequential kalman_step /
rts_smooth, float64 on the CPU.

Tolerances: 1e-9 relative against hdpgpc_tpu (the same elements composed
in the same order); 1e-8 against the sequential forms, a different
algorithm (Joseph-form covariance updates, one step at a time)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch.ops import kalman as tk
from hdpgpc_torch.ops.spd_solve import spd_solve_blocked_plain, spd_solve_plain
from hdpgpc_tpu.ops import kalman as jk

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T = 6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _spd(rng, d):
    M = rng.standard_normal((T, T)) / np.sqrt(T)
    return M @ M.T + d * np.eye(T)


def _system(seed, K=None):
    """(A, Gamma, C, Sigma, m0, P0), each with a leading K when given."""
    rng = np.random.default_rng(seed)

    def one():
        return (np.eye(T) + 0.05 * rng.standard_normal((T, T)),
                _spd(rng, 0.1), np.eye(T) + 0.05 * rng.standard_normal((T, T)),
                _spd(rng, 0.3), rng.standard_normal((T, 1)), _spd(rng, 0.5))
    if K is None:
        return one()
    return tuple(np.stack(x) for x in zip(*[one() for _ in range(K)]))


def _t(*xs):
    return [torch.tensor(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("N", [2, 5, 17])
def test_parallel_filter_matches_jax(N):
    sysm = _system(N)
    ys = np.random.default_rng(100 + N).standard_normal((N, T, 1))
    fj, Pj = jk.parallel_filter(*_j(ys, *sysm))
    ft, Pt = tk.parallel_filter(*_t(ys, *sysm))
    assert _rel(ft, fj) < 1e-9 and _rel(Pt, Pj) < 1e-9


@pytest.mark.parametrize("mask", ["random", "zeros", "ones", "lead_zero"])
def test_parallel_filter_masked_matches_jax(mask):
    N = 17
    rng = np.random.default_rng(3)
    sysm = _system(4)
    ys = rng.standard_normal((N, T, 1))
    h = {"random": (rng.random(N) > 0.4).astype(np.float64),
         "zeros": np.zeros(N), "ones": np.ones(N),
         "lead_zero": np.r_[0.0, 0.0, np.ones(N - 2)]}[mask]
    fj, Pj = jk.parallel_filter_masked(*_j(ys, h, *sysm))
    ft, Pt = tk.parallel_filter_masked(*_t(ys, h, *sysm))
    assert _rel(ft, fj) < 1e-9 and _rel(Pt, Pj) < 1e-9
    if mask == "zeros":
        # every step is the identity: the prior is carried unchanged
        np.testing.assert_array_equal(ft.numpy()[-1], sysm[4])
        np.testing.assert_array_equal(Pt.numpy()[-1], sysm[5])


def test_parallel_filter_masked_batched_over_clusters():
    """The classifier's form: one beat sequence, K clusters as a batch
    dim after the time axis, one mask column per cluster; each cluster
    equals hdpgpc_tpu's unbatched call."""
    N, K = 13, 3
    rng = np.random.default_rng(5)
    sysm = _system(6, K=K)
    ys = rng.standard_normal((N, T, 1))
    h = (rng.random((N, K)) > 0.5).astype(np.float64)
    ft, Pt = tk.parallel_filter_masked(torch.tensor(ys)[:, None],
                                       *_t(h, *sysm))
    for k in range(K):
        fj, Pj = jk.parallel_filter_masked(
            *_j(ys, h[:, k], *(x[k] for x in sysm)))
        assert _rel(ft[:, k], fj) < 1e-9 and _rel(Pt[:, k], Pj) < 1e-9


def test_parallel_smooth_matches_jax():
    N = 11
    rng = np.random.default_rng(8)
    A, G = _system(8)[:2]
    means = rng.standard_normal((N, T, 1))
    covs = np.stack([_spd(rng, 0.4) for _ in range(N)])
    gj, Lj = jk.parallel_smooth(*_j(A, G, means, covs))
    gt, Lt = tk.parallel_smooth(*_t(A, G, means, covs))
    assert _rel(gt, gj) < 1e-9 and _rel(Lt, Lj) < 1e-9


def test_parallel_forms_match_sequential():
    """Against kalman_step (first=False: predict, then update) and
    rts_smooth. The parallel filter's first element is an update from
    the prior without a prediction: kalman_step with A = I, Gamma = 0."""
    N = 12
    rng = np.random.default_rng(9)
    A, G, C, S, m0, P0 = _t(*_system(9))
    ys = torch.tensor(rng.standard_normal((N, T, 1)))
    h = torch.tensor((rng.random(N) > 0.3).astype(np.float64))
    params = tk.LDSParams(A, G, C, S)
    no_pred = tk.LDSParams(torch.eye(T, dtype=A.dtype), torch.zeros_like(G),
                           C, S)
    f, P = tk.kalman_step(m0, P0, ys[0], no_pred, False, 0.0)
    seq = [(f, P)]
    for t in range(1, N):
        f, P = tk.kalman_step(f, P, ys[t], params, False, 0.0)
        seq.append((f, P))
    fp, Pp = tk.parallel_filter(ys, A, G, C, S, m0, P0)
    assert _rel(fp, torch.stack([s[0] for s in seq])) < 1e-8
    assert _rel(Pp, torch.stack([s[1] for s in seq])) < 1e-8

    f, P = m0, P0
    gated = []
    for t in range(N):
        if h[t] > 0.5:
            f, P = tk.kalman_step(f, P, ys[t], params, False, 0.0)
        gated.append((f, P))
    fm, Pm = tk.parallel_filter_masked(ys, h, A, G, C, S, m0, P0)
    assert _rel(fm, torch.stack([s[0] for s in gated])) < 1e-8
    assert _rel(Pm, torch.stack([s[1] for s in gated])) < 1e-8

    fs, Ps = tk.rts_smooth(A.expand(N, T, T), G.expand(N, T, T), fp, Pp)
    gs, Ls = tk.parallel_smooth(A, G, fp, Pp)
    assert _rel(gs, fs) < 1e-8 and _rel(Ls, Ps) < 1e-8


def test_element_solves_kernel_b_route():
    """The filter elements' one shared solve, at the classifier's shape
    (K systems against [(Q H')', H, the chunk's beats], R = 2T + B),
    through kernel B's algorithm (spd_solve_blocked_plain, its step-by-
    step mirror) against the plain Cholesky solve the CPU takes: 1e-12
    relative."""
    K, B = 4, 40
    rng = np.random.default_rng(10)
    A, G, C, S = (torch.tensor(x) for x in _system(10, K=K)[:4])
    S_sh = C @ G @ C.transpose(1, 2) + S
    Y = torch.tensor(rng.standard_normal((K, T, B)))
    rhs = torch.cat([(G @ C.transpose(1, 2)).transpose(1, 2), C, Y],
                    dim=2).contiguous()
    Xb = spd_solve_blocked_plain(S_sh, rhs)
    Xp = spd_solve_plain(S_sh, rhs)
    assert Xp.shape == (K, T, 2 * T + B)
    assert _rel(Xb, Xp) < 1e-12
