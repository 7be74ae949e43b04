"""The ML-EM refit (bayesian_params=False), hdpgpc_tpu against the port,
float64:

* every function of models/ml_em.py on seeded inputs (an accepted and a
  rejected M-step, the static branch, a mask with padded tail slots) to
  <= 1e-10 relative;
* gplds.build_refit(emit_smoothed=True): the RefitResult and the
  smoothed member sequences to <= 1e-9 relative;
* the offline sweep with bayesian_params=False (the counterpart of
  tests/test_offline_e2e.py::test_offline_sweep_ml_em_path): identical
  partitions in every sweep, ELBO history to <= 1e-9 relative;
* include_sample and include_sample_fast with bayesian_params=False over
  12 growth-stream beats, the first three forced into three clusters,
  past cadence beats (the member-history EM of the online commit):
  identical decisions, q_last / q_lat_last to <= 1e-9 relative.

The reference's include_sample runs in a subprocess with XLA's backend
optimisation off (ROADMAP C; tests/test_torch_online.py), and is handed
writable copies of its forward-backward's outputs, which it writes into
under force_model (tests/test_torch_warp.py)."""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch import convert
from hdpgpc_torch.data.loader import default_x_basis, synthetic_growth_stream
from hdpgpc_torch.models import gplds as tg
from hdpgpc_torch.models import ml_em as tm
from hdpgpc_torch.models.hdpgpc import HDPGPC as TorchHDPGPC
from hdpgpc_tpu.data.loader import synthetic_beats
from hdpgpc_tpu.data.priors import compute_estimators_lds
from hdpgpc_tpu.models import gplds as jg
from hdpgpc_tpu.models import ml_em as jm
from hdpgpc_tpu.models.hdpgpc import HDPGPC as JaxHDPGPC
from hdpgpc_tpu.ops.kernels import KernelParams as JKP

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_ON, N_ON, N_SEED = 24, 12, 3
X_ON = np.arange(T_ON, dtype=np.float64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _lds(N=12, T=5, seed=0):
    """(A, Gamma, C, Sigma, ys, means, covs) with SPD covariances."""
    rng = np.random.default_rng(seed)

    def spd(s):
        M = rng.standard_normal((T, T))
        return (M @ M.T + np.eye(T)) * s

    A = np.eye(T) + 0.05 * rng.standard_normal((T, T))
    C = np.eye(T) + 0.05 * rng.standard_normal((T, T))
    ys = rng.standard_normal((N, T, 1))
    means = ys + 0.1 * rng.standard_normal((N, T, 1))
    covs = np.stack([spd(0.02) for _ in range(N)])
    return A, spd(0.05), C, spd(0.1), ys, means, covs


def _both(fn, *args, **kw):
    a = getattr(jm, fn)(*map(jnp.asarray, args), **kw)
    b = getattr(tm, fn)(*map(torch.as_tensor, args), **kw)
    return a, b


def _check(a, b, tol=1e-10):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert _rel(y, x) <= tol


W_TAIL = np.r_[np.ones(9), np.zeros(3)]


@pytest.mark.parametrize("seed", [0, 1])
def test_ml_em_functions_match_jax(seed):
    A, G, C, S, ys, means, covs = _lds(seed=seed)
    _check(*_both("_moments", A, G, means, covs))
    _check(*_both("m_step_dynamic", A, G, C, S, ys, means, covs))
    _check(*_both("m_step_static", ys, means, covs))
    _check(*_both("joint_log_likelihood", A, G, C, S, ys, means, covs))
    for w in (W_TAIL, np.ones(12)):
        _check(*_both("m_step_dynamic_masked", A, G, C, S, ys, means, covs,
                      w))
        _check(*_both("joint_log_likelihood_masked", A, G, C, S, ys, means,
                      covs, w))
        _check(*_both("masked_rts", A, G, means, covs, w))
    for model_type in ("dynamic", "static"):
        _check(jm.ml_update(A, G, C, S, ys, means, covs,
                            model_type=model_type),
               tm.ml_update(A, G, C, S, ys, means, covs,
                            model_type=model_type))
        _check(jm.ml_update_masked(A, G, C, S, ys, means, covs, W_TAIL,
                                   model_type=model_type),
               tm.ml_update_masked(A, G, C, S, ys, means, covs, W_TAIL,
                                   model_type=model_type))


def test_ml_update_guards_match_jax():
    """An M-step that lowers the likelihood is rejected (the inputs come
    back unchanged) and one that raises it is accepted, in both."""
    A, G, C, S, ys, means, covs = _lds(seed=1)
    outcomes = []
    for Sc in (S, S * 1e3):
        a = jm.ml_update_masked(A, G, C, Sc, ys, means, covs, W_TAIL)
        b = tm.ml_update_masked(A, G, C, Sc, ys, means, covs, W_TAIL)
        _check(a, b)
        outcomes.append(np.array_equal(np.asarray(a[3]), Sc))
    assert sorted(outcomes) == [False, True]
    for n in (0, 3, 7, 15, 30, 510, 515):
        assert tm.reestimate_cadence(n) == jm.reestimate_cadence(n)


@pytest.mark.parametrize("bucket", [None, 16])
def test_build_refit_emit_smoothed_matches_jax(bucket):
    T, N = 12, 30
    rng = np.random.default_rng(2)
    Y = (np.sin(np.linspace(0, 2 * np.pi, T))[None]
         + 0.1 * rng.standard_normal((N, T)))
    resp = (rng.uniform(size=N) < 0.5).astype(np.float64)
    resp[:2] = 1.0
    th = JKP(jnp.asarray(1.5), jnp.asarray(2.0), jnp.asarray(0.05))
    st_j = jg.init_cluster_state(jnp.arange(T, dtype=jnp.float64), th,
                                 0.02, 0.1, 5.0)
    kw = dict(update_params=False, pair_smooth=True, full_backward=True,
              bucket=bucket, emit_smoothed=True)
    rj, sj = jg.build_refit(T, **kw)(jnp.asarray(Y), jnp.asarray(resp),
                                     st_j)
    st_t = convert.cluster_state_from_numpy(jax.device_get(st_j))
    rt, st = tg.build_refit(T, **kw)(torch.as_tensor(Y),
                                     torch.as_tensor(resp), st_t)
    assert len(st) == len(sj) == 4
    for a, b in zip(st, sj):
        assert tuple(a.shape) == tuple(b.shape)
        assert _rel(a, b) <= 1e-9
    for f in ("q", "q_lat", "snr"):
        assert _rel(getattr(rt, f), getattr(rj, f)) <= 1e-9, f
    leaves_t = []
    tg.tree_map(lambda v: leaves_t.append(v.numpy()) or v, rt.state)
    for a, b in zip(leaves_t, jax.tree_util.tree_leaves(rj.state)):
        assert _rel(a, b) <= 1e-9


def _sweep(cls, y, **kw):
    T = y.shape[1]
    std, std_dif, bs, bg = compute_estimators_lds(y)
    m = cls(default_x_basis(T), n_outputs=1, ini_lengthscale=3.0,
            bound_lengthscale=(1.0, 20.0), ini_gamma=std_dif, ini_sigma=std,
            ini_outputscale=10.0, bound_sigma=bs, bound_gamma=bg,
            hmm_switch=True, max_models=100, bayesian_params=False,
            reestimate_initial_params=True, n_explore_steps=3,
            free_deg_MNIV=5, compute_dtype="float64", **kw)
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters=300))
    x = np.tile(np.arange(T, dtype=np.float64), (y.shape[0], 1))
    with contextlib.redirect_stdout(io.StringIO()):
        m.include_batch(x, y, with_warp=False)
    return m


def test_offline_ml_em_sweep_matches_jax():
    y, z = synthetic_beats(60, T=24, n_clusters=3, noise=0.03, seed=0)
    mj = _sweep(JaxHDPGPC, y)
    mt = _sweep(TorchHDPGPC, y, device="cpu")
    assert mt.M == mj.M
    assert len(mt.resp_assigned) == len(mj.resp_assigned)
    for a, b in zip(mt.resp_assigned, mj.resp_assigned):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(mt.train_elbo, mj.train_elbo, rtol=1e-9)
    lab = mt.resp_assigned[-1]
    err = sum(int(np.sum(z[lab == m] != np.bincount(z[lab == m]).argmax()))
              for m in np.unique(lab))
    assert err / 60 < 0.15
    # the ML path ran: no MNIW posterior advanced past its prior
    for ct, cj in zip(mt.clusters[0], mj.clusters[0]):
        np.testing.assert_array_equal(ct.members, cj.members)
        if ct.members.size > 1:
            assert float(ct.state.mniw_int.n0) == pytest.approx(5.0)
            for f in ("A", "Gamma", "C", "Sigma"):
                assert _rel(getattr(ct.state, f),
                            np.asarray(getattr(cj.state, f))) <= 1e-9, f


def _stream_y():
    y, _z = synthetic_growth_stream(N_ON, T_ON, 4, seed=7, start_beat=0,
                                    interval=1)
    return y


def _online_kw(y):
    std = float(np.std(y))
    sd = float(np.std(np.diff(y, axis=0)))
    return dict(n_outputs=1, ini_lengthscale=3.0,
                bound_lengthscale=(1.0, 20.0), ini_gamma=sd, ini_sigma=std,
                ini_outputscale=4.0, bound_sigma=(std * 0.05, std * 0.2),
                bound_gamma=(sd * 0.05, sd * 0.2), hmm_switch=True,
                max_models=4, bayesian_params=False, estimation_limit=50,
                free_deg_MNIV=5, compute_dtype="float64")


_JAX_IS = """
import contextlib, io, sys
import numpy as np
sys.path.insert(0, {root!r})
from hdpgpc_tpu.data.loader import default_x_basis
from hdpgpc_tpu.models.hdpgpc import HDPGPC
y = np.load({path!r} + ".in.npy")
X = np.arange(y.shape[1], dtype=np.float64)
m = HDPGPC(default_x_basis(y.shape[1]), **{kw!r})
# writable copies of the forward-backward's read-only outputs, which
# hdpgpc_tpu's include_sample writes into under force_model
vlt = m._vlt_online
m._vlt_online = lambda *a, **k: tuple(np.array(v) for v in vlt(*a, **k))
with contextlib.redirect_stdout(io.StringIO()):
    for i in range(y.shape[0]):
        m.include_sample(X, y[i], with_warp=False,
                         force_model=i if i < {n_seed} else None)
out = dict(M=m.M, q_last=m.q_last, q_lat_last=m.q_lat_last)
out.update({{f"ra{{i}}": r for i, r in enumerate(m.resp_assigned)}})
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_include_sample(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_is_ml") / "out.npz")
    y = _stream_y()
    np.save(path + ".in.npy", y)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_IS.format(root=ROOT, path=path,
                                              kw=_online_kw(y),
                                              n_seed=N_SEED)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    class Handle:
        out = None

        def get(self):
            if self.out is None:
                _so, se = proc.communicate(timeout=900)
                assert proc.returncode == 0, se[-3000:]
                self.out = dict(np.load(path))
            return self.out

    yield Handle()
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _port_stream(fn, calls):
    y = _stream_y()
    m = TorchHDPGPC(default_x_basis(T_ON), **_online_kw(y), device="cpu")
    inner = m._full_refit_ml

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    m._full_refit_ml = counted
    with contextlib.redirect_stdout(io.StringIO()):
        for i in range(N_ON):
            getattr(m, fn)(X_ON, y[i], with_warp=False,
                           force_model=i if i < N_SEED else None)
    return m


def _same(mt, M, ra, q_last, q_lat_last):
    assert mt.M == M
    assert len(mt.resp_assigned) == N_ON
    for i, a in enumerate(mt.resp_assigned):
        np.testing.assert_array_equal(a, ra(i))
    for a, b in ((mt.q_last, q_last), (mt.q_lat_last, q_lat_last)):
        assert a.shape == b.shape
        f_ = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), f_)
        assert np.max(np.abs(a[f_] - b[f_])) <= 1e-9 * max(
            np.max(np.abs(b[f_])), 1e-300)


def test_include_sample_ml_em_matches_jax(jax_include_sample):
    calls = []
    mt = _port_stream("include_sample", calls)
    ref = jax_include_sample.get()
    _same(mt, int(ref["M"]), lambda i: ref[f"ra{i}"], ref["q_last"],
          ref["q_lat_last"])
    assert len(calls) >= 2       # cadence beats re-estimated by EM


def test_include_sample_fast_ml_em_matches_jax():
    calls = []
    mt = _port_stream("include_sample_fast", calls)
    y = _stream_y()
    mj = JaxHDPGPC(default_x_basis(T_ON), **_online_kw(y))
    with contextlib.redirect_stdout(io.StringIO()):
        for i in range(N_ON):
            mj.include_sample_fast(X_ON, y[i], with_warp=False,
                                   force_model=i if i < N_SEED else None)
    _same(mt, mj.M, lambda i: mj.resp_assigned[i], mj.q_last,
          mj.q_lat_last)
    assert len(calls) >= 2
