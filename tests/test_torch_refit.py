"""models.gplds.build_refit against hdpgpc_tpu's, with the JAX state
carried into the port through hdpgpc_torch.convert.

float64: every RefitResult leaf (q, q_lat, snr, lds and the whole
compact state) to <= 1e-9 relative to the leaf's largest magnitude.
float32: per output, at the tolerances stated at the call."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch import convert
from hdpgpc_torch.models import gplds as tg
from hdpgpc_tpu.models import gplds as jg
from hdpgpc_tpu.ops.kernels import KernelParams as JKP

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)


def _state(T, dtype=jnp.float64):
    th = JKP(jnp.asarray(1.5), jnp.asarray(2.0), jnp.asarray(0.05))
    return jg.init_cluster_state(jnp.arange(T, dtype=jnp.float64), th,
                                 0.02, 0.1, 5.0, dtype=dtype)


def _data(N, T, seed=0):
    rng = np.random.default_rng(seed)
    return (np.sin(np.linspace(0, 2 * np.pi, T))[None]
            + 0.1 * rng.standard_normal((N, T)))


def _leaves_torch(x):
    out = []
    tg.tree_map(lambda t: out.append(t.cpu().numpy()) or t, x)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _run_both(T, Y, resp, st_j, dtype=torch.float64, **kw):
    rj = jg.build_refit(T, free_deg=5.0, **kw)(
        jnp.asarray(Y), jnp.asarray(resp), st_j)
    st_t = convert.cluster_state_from_numpy(jax.device_get(st_j),
                                            dtype=dtype)
    rt = tg.build_refit(T, free_deg=5.0, **kw)(
        torch.as_tensor(Y, dtype=dtype), torch.as_tensor(resp, dtype=dtype),
        st_t)
    return rt, rj


CASES = list(itertools.product([None, 6], [True, False], [True, False],
                               [None, 16]))


@pytest.mark.parametrize("est_limit,update_params,pair_smooth,bucket",
                         CASES)
def test_refit_f64_matches_jax(est_limit, update_params, pair_smooth,
                               bucket):
    T, N = 12, 40
    Y = _data(N, T)
    resp = np.zeros(N)
    resp[np.linspace(0, N - 1, 14).astype(int)] = 1.0
    rt, rj = _run_both(T, Y, resp, _state(T), est_limit=est_limit,
                       update_params=update_params, pair_smooth=pair_smooth,
                       bucket=bucket)
    for f in ("q", "q_lat", "snr", "lds"):
        assert _rel(getattr(rt, f).numpy(), getattr(rj, f)) <= 1e-9, f
    jl = jax.tree.leaves(jax.device_get(rj.state))
    for i, (a, b) in enumerate(zip(_leaves_torch(rt.state), jl)):
        assert _rel(a, b) <= 1e-9, (i, jg.ClusterState._fields)


@pytest.mark.parametrize("n_members", [30, 6, 3, 1, 0])
def test_refit_hybrid_tail_f64_matches_jax(n_members):
    """est_limit=6 with members past the limit: the parallel frozen tail
    (_tail_filter / _tail_smooth) against the reference's."""
    T, N = 10, 36
    Y = _data(N, T, seed=n_members)
    resp = np.zeros(N)
    resp[:n_members] = 1.0
    rt, rj = _run_both(T, Y, resp, _state(T), est_limit=6)
    for f in ("q", "q_lat", "snr", "lds"):
        assert _rel(getattr(rt, f).numpy(), getattr(rj, f)) <= 1e-9, f
    for a, b in zip(_leaves_torch(rt.state),
                    jax.tree.leaves(jax.device_get(rj.state))):
        assert _rel(a, b) <= 1e-9


def test_refit_continuation_state_matches_jax():
    """A second refit from a non-fresh state (n_before > 0)."""
    T, N = 10, 30
    Y = _data(N, T, seed=5)
    r1 = np.zeros(N)
    r1[:4] = 1.0
    st1 = jg.build_refit(T, est_limit=6)(jnp.asarray(Y), jnp.asarray(r1),
                                        _state(T)).state
    r2 = np.zeros(N)
    r2[10:25] = 1.0
    rt, rj = _run_both(T, Y, r2, st1, est_limit=6)
    for f in ("q", "q_lat", "snr"):
        assert _rel(getattr(rt, f).numpy(), getattr(rj, f)) <= 1e-9, f


def test_batched_jobs_equal_single_jobs():
    """The job dimension replaces jax.vmap: a batch of 3 jobs equals 3
    single-job refits."""
    T, N = 10, 24
    st = convert.cluster_state_from_numpy(jax.device_get(_state(T)))
    refit = tg.build_refit(T, est_limit=6, free_deg=5.0)
    Ys = [torch.tensor(_data(N, T, seed=s)) for s in range(3)]
    Rs = [torch.tensor((np.arange(N) % (s + 2) == 0).astype(np.float64))
          for s in range(3)]
    rb = refit(torch.stack(Ys), torch.stack(Rs),
               tg.stack_states([st] * 3))
    for j in range(3):
        r1 = refit(Ys[j], Rs[j], st)
        for a, b in zip(_leaves_torch(tg.index_state(rb, j)),
                        _leaves_torch(r1)):
            assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("est_limit,N,n_mem", [(None, 40, 14), (50, 400, 360)])
def test_refit_f32_matches_jax(est_limit, N, n_mem):
    """float32 speed mode, per output: scores are O(10-100) sums of
    float32 products, so they agree to 2e-3 relative / 5e-2 absolute;
    the smoothed mean to 1e-3. The (50, 400, 360) case takes the
    warm-up + steady-state tail (_tail_steady)."""
    T = 16 if N == 400 else 12
    Y = _data(N, T, seed=7).astype(np.float32)
    resp = np.zeros(N, np.float32)
    resp[:n_mem] = 1.0
    rt, rj = _run_both(T, Y, resp, _state(T, jnp.float32),
                       dtype=torch.float32, est_limit=est_limit)
    np.testing.assert_allclose(rt.q.numpy(), np.asarray(rj.q), rtol=2e-3,
                               atol=2e-2)
    np.testing.assert_allclose(rt.q_lat.numpy(), np.asarray(rj.q_lat),
                               rtol=2e-3, atol=5e-2)
    np.testing.assert_allclose(rt.snr.numpy(), np.asarray(rj.snr),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(rt.state.f_sm_last.numpy(),
                               np.asarray(rj.state.f_sm_last),
                               rtol=1e-3, atol=1e-3)
    assert int(rt.state.n) == int(rj.state.n)
    assert rt.q.dtype == torch.float32
