"""The GP observation APIs of the port's models/gplds.py (observe,
observe_latent, sample_observations, kl_divergence) against
hdpgpc_tpu's, float64 on the CPU, on the cluster of
tests/test_gplds_api.py (T = 20, a smooth latent mean) with random
latent covariances. Tolerance 1e-9 relative (a few (T, T) solves)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch.convert import cluster_state_from_numpy
from hdpgpc_torch.models import gplds as tg
from hdpgpc_tpu.models import gplds as jg
from hdpgpc_tpu.ops.kernels import KernelParams

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T = 20


def _spd(rng, d):
    M = rng.standard_normal((T, T)) / np.sqrt(T)
    return M @ M.T + d * np.eye(T)


def _state(seed):
    """The same cluster in both packages."""
    rng = np.random.default_rng(seed)
    theta = KernelParams(jnp.asarray(2.0), jnp.asarray(3.0),
                         jnp.asarray(0.05))
    st = jg.init_cluster_state(jnp.arange(T, dtype=jnp.float64), theta,
                               0.01, 0.1, 5.0)
    t = np.arange(T) / T
    f = np.sin(2 * np.pi * t + seed)[:, None]
    st = st._replace(
        f_last=jnp.asarray(f), f_sm_last=jnp.asarray(0.9 * f),
        P_last=jnp.asarray(0.05 * _spd(rng, 0.2)),
        P_sm_last=jnp.asarray(0.04 * _spd(rng, 0.2)),
        Sigma=jnp.asarray(0.1 * _spd(rng, 0.5)),
        C=jnp.asarray(np.eye(T) + 0.02 * rng.standard_normal((T, T))))
    return st, cluster_state_from_numpy(jax.device_get(st))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("grid", ["shared", "sub", "off"])
@pytest.mark.parametrize("fn,smoothed", [("observe", False),
                                         ("observe", True),
                                         ("observe_latent", True),
                                         ("observe_latent", False)])
def test_observe_matches_jax(grid, fn, smoothed):
    sj, st = _state(1)
    x = np.arange(T, dtype=np.float64)
    x_post = {"shared": x, "sub": x[::2], "off": x[:-1] + 0.5}[grid]
    fj, cj = getattr(jg, fn)(sj, jnp.asarray(x_post), jnp.asarray(x),
                             use_smoothed=smoothed)
    ft, ct = getattr(tg, fn)(st, torch.tensor(x_post), torch.tensor(x),
                             use_smoothed=smoothed)
    assert ft.shape == tuple(fj.shape) and ct.shape == tuple(cj.shape)
    if grid == "shared":
        # the stored moments (observe's mean is the product C f)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert _rel(ft, fj) < 1e-12
        if fn == "observe_latent":
            np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    else:
        assert _rel(ft, fj) < 1e-9 and _rel(ct, cj) < 1e-9


def test_kl_divergence_matches_jax():
    sa_j, sa_t = _state(1)
    sb_j, sb_t = _state(2)
    kj = float(jg.kl_divergence(sa_j, sb_j))
    kt = float(tg.kl_divergence(sa_t, sb_t))
    assert abs(kt - kj) <= 1e-9 * abs(kj)
    assert abs(float(tg.kl_divergence(sa_t, sa_t))) < 1e-9


def test_sample_observations():
    """The map from standard normals equals hdpgpc_tpu's for the
    normals its key draws; with a seeded torch.Generator the samples
    have the distribution's moments."""
    sj, st = _state(3)
    key = jax.random.PRNGKey(0)
    yj = jg.sample_observations(sj, key, n_samples=5)
    z = jax.random.normal(key, (5, T), jnp.float64)
    yt = tg._sample_from_normals(st, torch.tensor(np.asarray(z)))
    assert _rel(yt, yj) < 1e-12
    n = 40000
    gen = torch.Generator().manual_seed(0)
    ys = tg.sample_observations(st, gen, n_samples=n).numpy()
    assert ys.shape == (n, T)
    mean, cov = (t.numpy() for t in tg._observation_moments(st))
    sd = np.sqrt(np.diag(cov))
    assert np.max(np.abs(ys.mean(0) - mean) / sd) < 5.0 / np.sqrt(n)
    emp = np.cov(ys.T)
    assert np.max(np.abs(emp - cov)) / np.max(np.diag(cov)) < 0.05
    again = tg.sample_observations(st, torch.Generator().manual_seed(0),
                                   n_samples=n).numpy()
    np.testing.assert_array_equal(ys, again)
