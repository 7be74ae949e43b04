"""The monotone warp, hdpgpc_tpu against the port, float64 unless a test
says otherwise:

* make_warp_prior / warp_prior_score, and build_batch_warp (B = 5,
  T = 32, 150 Adam steps, a template bump, shifted copies and the
  template itself) to <= 1e-9 relative;
* the warp runs in float64 in a float32 model, in both packages;
* include_batch(with_warp=True) at 1 and 2 leads (T = 24, N = 40, a
  300-step kernel-fit budget, as tests/test_torch_slice.py): identical
  partitions in every sweep, ELBO history to <= 1e-9 relative;
* include_sample_fast and include_sample with the warp on, in the
  standard, greedy and greedy_bound strategies and with force_model,
  over 12 beats of the growth stream (the first three forced, without
  the warp, into three clusters, so that the strategies rank and gate
  real alternatives): identical decisions, q_last / q_lat_last to
  <= 1e-9 relative; the fast path also at 2 leads, where the last lead's
  warp scores enter every lead (a quirk of the reference);
* compute_warp_actual_state: warped beats, offsets, scores and the
  rescored q / q_lat to <= 1e-9 relative.

The reference's include_sample runs in a subprocess with XLA's backend
optimisation off (its optimised hmm.backward is miscompiled on this CPU,
ROADMAP C; tests/test_torch_online.py has the details). There, with
force_model at t > 0, hdpgpc_tpu writes into read-only arrays returned
by its forward-backward and raises; the subprocess hands it writable
copies of the same values."""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch.data.loader import default_x_basis, synthetic_growth_stream
from hdpgpc_torch.models.hdpgpc import HDPGPC as TorchHDPGPC
from hdpgpc_torch.warp import monotone as tw
from hdpgpc_tpu.data.loader import synthetic_beats
from hdpgpc_tpu.data.priors import compute_estimators_lds
from hdpgpc_tpu.models.hdpgpc import HDPGPC as JaxHDPGPC
from hdpgpc_tpu.warp import monotone as jw

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_ON, N_ON, N_SEED = 24, 12, 3
X_ON = np.arange(T_ON, dtype=np.float64)
METHODS = ["standard", "greedy", "greedy_bound", "force"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _bumps(T, B, seed=0):
    t = np.arange(T) / T
    rng = np.random.default_rng(seed)
    template = np.exp(-0.5 * ((t - 0.5) / 0.08) ** 2)
    shifts = np.r_[0.0, rng.uniform(-0.1, 0.1, B - 1)]
    Y = np.exp(-0.5 * ((t[None] - 0.5 - shifts[:, None]) / 0.08) ** 2)
    return template, Y + 0.01 * rng.standard_normal((B, T)) * (shifts != 0)[
        :, None]


def test_warp_prior_and_score_match_jax():
    T = 32
    x = np.arange(T, dtype=np.float64)
    pj = jw.make_warp_prior(jnp.asarray(x), 0.05, (1e-6, 1e2))
    pt = tw.make_warp_prior(torch.as_tensor(x), 0.05, (1e-6, 1e2))
    assert _rel(pt.L, pj.L) <= 1e-12
    assert _rel(pt.logdet, pj.logdet) <= 1e-12
    W = np.random.default_rng(1).standard_normal((4, T)) * 0.1
    assert _rel(tw.warp_prior_score(pt, torch.as_tensor(W)),
                jw.warp_prior_score(pj, jnp.asarray(W))) <= 1e-12
    # the noise is clamped into the bounds
    pt2 = tw.make_warp_prior(torch.as_tensor(x), 5.0, (1e-6, 0.1))
    pj2 = jw.make_warp_prior(jnp.asarray(x), 5.0, (1e-6, 0.1))
    assert _rel(pt2.logdet, pj2.logdet) <= 1e-12


def test_build_batch_warp_matches_jax():
    """Row 0 is the template itself: its first Adam step is taken on a
    residual of pure rounding, which the port reproduces only because it
    sums the cumulative increments in XLA's order."""
    T, B = 32, 5
    x = np.arange(T, dtype=np.float64)
    template, Y = _bumps(T, B)
    pj = jw.make_warp_prior(jnp.asarray(x), 0.05, (1e-6, 1e2))
    pt = tw.make_warp_prior(torch.as_tensor(x), 0.05, (1e-6, 1e2))
    rj = jw.build_batch_warp(T, n_ctrl=8, train_iter=150)(
        jnp.asarray(x), jnp.asarray(Y), jnp.asarray(template), pj,
        jnp.asarray(3.0), jnp.asarray(1.0), jnp.asarray(0.02))
    rt = tw.build_batch_warp(T, n_ctrl=8, train_iter=150)(
        torch.as_tensor(x), torch.as_tensor(Y), torch.as_tensor(template),
        pt, 3.0, 1.0, 0.02)
    for f in jw.WarpResult._fields:
        assert _rel(getattr(rt, f), getattr(rj, f)) <= 1e-9, f
    g = rt.x_warp.numpy() + x
    assert np.all(np.diff(g, axis=1) > 0)


def test_warp_runs_in_float64_in_a_float32_model():
    """hdpgpc_tpu enables x64 and hands the warp float64 host beats, so
    its warp is float64 even in a float32 model; the port's too."""
    y, _z = synthetic_beats(8, T=T_ON, n_clusters=2, noise=0.03, seed=5)
    std, sd, bs, bg = compute_estimators_lds(y)
    out = {}
    for name, cls, kw in (("jax", JaxHDPGPC, {}),
                          ("port", TorchHDPGPC, {"device": "cpu"})):
        m = cls(default_x_basis(T_ON), n_outputs=1, ini_gamma=sd,
                ini_sigma=std, ini_outputscale=10.0, bound_sigma=bs,
                bound_gamma=bg, compute_dtype="float32", **kw)
        m.cfg = dataclasses.replace(m.cfg, warp=dataclasses.replace(
            m.cfg.warp, train_iter_online=40))
        with contextlib.redirect_stdout(io.StringIO()):
            m.include_sample_fast(X_ON, y[0], with_warp=False)
        out[name] = m._warp_one(y[1, :, 0], 0, 0, m._warp_setup())
    (yj, xj, lj), (yt, xt, lt) = out["jax"], out["port"]
    assert yj.dtype == xj.dtype == np.float64
    assert yt.dtype == xt.dtype == np.float64
    assert isinstance(lj, float) and isinstance(lt, float)
    # the templates come from float32 states
    np.testing.assert_allclose(yt, yj, rtol=1e-4, atol=1e-5)


def _sweep(cls, y, **kw):
    T = y.shape[1]
    std, std_dif, bs, bg = compute_estimators_lds(y)
    m = cls(default_x_basis(T), n_outputs=y.shape[2], ini_lengthscale=3.0,
            bound_lengthscale=(1.0, 20.0), ini_gamma=std_dif, ini_sigma=std,
            ini_outputscale=10.0, bound_sigma=bs, bound_gamma=bg,
            hmm_switch=True, max_models=100, bayesian_params=True,
            reestimate_initial_params=True, n_explore_steps=3,
            free_deg_MNIV=5, compute_dtype="float64", **kw)
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters=300))
    x = np.tile(np.arange(T, dtype=np.float64), (y.shape[0], 1))
    with contextlib.redirect_stdout(io.StringIO()):
        m.include_batch(x, y, with_warp=True)
    return m


@pytest.mark.parametrize("leads", [1, 2])
def test_include_batch_with_warp_matches_jax(leads):
    y, z = synthetic_beats(40, T=24, n_clusters=3, n_outputs=leads,
                           noise=0.03, seed=0)
    mj = _sweep(JaxHDPGPC, y)
    mt = _sweep(TorchHDPGPC, y, device="cpu")
    assert mt.M == mj.M
    assert len(mt.resp_assigned) == len(mj.resp_assigned) >= 2
    for a, b in zip(mt.resp_assigned, mj.resp_assigned):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(mt.train_elbo, mj.train_elbo, rtol=1e-9)
    # the sweep warped: one cached batch warp per (lead, representative)
    assert sorted(mt._warp_cache) == sorted(mj._warp_cache)
    assert len(mt._warp_cache) >= 2 * leads
    for k, (xw, yw, lk) in mt._warp_cache.items():
        for a, b in zip((xw, yw, lk), mj._warp_cache[k]):
            assert _rel(a, b) <= 1e-9, k


# ---------------------------------------------------------------------------
# online
# ---------------------------------------------------------------------------

def _stream_data(leads):
    y, _z = synthetic_growth_stream(N_ON + 1, T_ON, 4, seed=7, start_beat=0,
                                    interval=1)
    if leads == 1:
        return y[:, :, None]
    y2, _ = synthetic_growth_stream(N_ON + 1, T_ON, 4, seed=8, start_beat=0,
                                    interval=1)
    return np.stack([y, 0.5 * y + 0.5 * y2], axis=2)


def _online_kw(y, method):
    std = float(np.std(y))
    sd = float(np.std(np.diff(y, axis=0)))
    return dict(n_outputs=y.shape[2], ini_lengthscale=3.0,
                bound_lengthscale=(1.0, 20.0), ini_gamma=sd, ini_sigma=std,
                ini_outputscale=4.0, bound_sigma=(std * 0.05, std * 0.2),
                bound_gamma=(sd * 0.05, sd * 0.2), hmm_switch=True,
                max_models=8, bayesian_params=True, estimation_limit=50,
                free_deg_MNIV=5, compute_dtype="float64",
                method_compute_warp="greedy" if method == "force" else method)


def _online_model(cls, y, method, **kw):
    m = cls(default_x_basis(T_ON), **_online_kw(y, method), **kw)
    m.cfg = dataclasses.replace(
        m.cfg, gp=dataclasses.replace(m.cfg.gp, kernel_fit_iters=300),
        warp=dataclasses.replace(m.cfg.warp, train_iter_online=40))
    return m


def _stream(m, fn, y, method):
    """Beats 0-2 forced into clusters 0, 1, 2 without the warp (a forced
    birth cannot be warped against: the cluster does not exist yet);
    then the warp, free decisions, or force_model = i % M."""
    with contextlib.redirect_stdout(io.StringIO()):
        for i in range(N_ON):
            if i < N_SEED:
                getattr(m, fn)(X_ON, y[i], with_warp=False, force_model=i)
            else:
                fm = i % m.M if method == "force" else None
                getattr(m, fn)(X_ON, y[i], with_warp=True, force_model=fm)
    return m


_JAX_IS = """
import contextlib, dataclasses, io, sys
import numpy as np
sys.path.insert(0, {root!r})
from hdpgpc_tpu.data.loader import default_x_basis
from hdpgpc_tpu.models.hdpgpc import HDPGPC
y = np.load({path!r} + ".in.npy")
X = np.arange(y.shape[1], dtype=np.float64)
out = {{}}
for method in {methods!r}:
    kw = dict({kw!r}, method_compute_warp="greedy" if method == "force"
              else method)
    m = HDPGPC(default_x_basis(y.shape[1]), **kw)
    # hdpgpc_tpu's include_sample writes into the arrays its
    # forward-backward returns, which are read-only (jax arrays seen
    # through numpy) whenever force_model is given at t > 0; writable
    # copies, the same values, let the reference run that path
    vlt = m._vlt_online
    m._vlt_online = lambda *a, **k: tuple(np.array(v) for v in vlt(*a, **k))
    m.cfg = dataclasses.replace(
        m.cfg, gp=dataclasses.replace(m.cfg.gp, kernel_fit_iters=300),
        warp=dataclasses.replace(m.cfg.warp, train_iter_online=40))
    with contextlib.redirect_stdout(io.StringIO()):
        for i in range({n}):
            if i < {n_seed}:
                m.include_sample(X, y[i], with_warp=False, force_model=i)
            else:
                fm = i % m.M if method == "force" else None
                m.include_sample(X, y[i], with_warp=True, force_model=fm)
    out[method + ".M"] = m.M
    out[method + ".q_last"] = m.q_last
    out[method + ".q_lat_last"] = m.q_lat_last
    for i, r in enumerate(m.resp_assigned):
        out[method + f".ra{{i}}"] = r
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_include_sample(tmp_path_factory):
    """The reference's include_sample over the stream, every strategy, in
    its subprocess, started before the module's first test."""
    path = str(tmp_path_factory.mktemp("jax_is_warp") / "out.npz")
    y = _stream_data(1)
    np.save(path + ".in.npy", y)
    kw = _online_kw(y, "greedy")
    kw.pop("method_compute_warp")
    code = _JAX_IS.format(root=ROOT, path=path, methods=METHODS, kw=kw,
                          n=N_ON, n_seed=N_SEED)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
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


def _same_stream(mt, M, ra, q_last, q_lat_last):
    assert mt.M == M >= 2
    assert len(mt.resp_assigned) == N_ON
    for i, a in enumerate(mt.resp_assigned):
        np.testing.assert_array_equal(a, ra(i))
    for a, b in ((mt.q_last, q_last), (mt.q_lat_last, q_lat_last)):
        assert a.shape == b.shape
        f_ = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), f_)
        assert np.max(np.abs(a[f_] - b[f_])) <= 1e-9 * max(
            np.max(np.abs(b[f_])), 1e-300)


@pytest.mark.parametrize("method", METHODS)
def test_include_sample_fast_with_warp_matches_jax(method):
    y = _stream_data(1)
    mj = _stream(_online_model(JaxHDPGPC, y, method),
                 "include_sample_fast", y, method)
    mt = _stream(_online_model(TorchHDPGPC, y, method, device="cpu"),
                 "include_sample_fast", y, method)
    _same_stream(mt, mj.M, lambda i: mj.resp_assigned[i], mj.q_last,
                 mj.q_lat_last)


@pytest.mark.parametrize("method", METHODS)
def test_include_sample_with_warp_matches_jax(method, jax_include_sample):
    y = _stream_data(1)
    mt = _stream(_online_model(TorchHDPGPC, y, method, device="cpu"),
                 "include_sample", y, method)
    ref = jax_include_sample.get()
    _same_stream(mt, int(ref[method + ".M"]),
                 lambda i: ref[method + f".ra{i}"], ref[method + ".q_last"],
                 ref[method + ".q_lat_last"])


def test_two_leads_share_the_last_leads_warp_scores():
    """Two leads, greedy: the reference reassigns liks inside its lead
    loop, so lead 1's warp scores enter lead 0's row too; the port keeps
    that, and the two leads' own scores differ (the quirk is visible)."""
    y = _stream_data(2)
    mj = _stream(_online_model(JaxHDPGPC, y, "greedy"),
                 "include_sample_fast", y, "greedy")
    mt = _stream(_online_model(TorchHDPGPC, y, "greedy", device="cpu"),
                 "include_sample_fast", y, "greedy")
    _same_stream(mt, mj.M, lambda i: mj.resp_assigned[i], mj.q_last,
                 mj.q_lat_last)
    y_new = y[N_ON]
    with contextlib.redirect_stdout(io.StringIO()):
        _qt, rt, lt = mt.include_sample_fast(X_ON, y_new, with_warp=True,
                                             classify=True)
        _qj, rj, lj = mj.include_sample_fast(X_ON, y_new, with_warp=True,
                                             classify=True)
    np.testing.assert_array_equal(rt, np.asarray(rj))
    assert _rel(lt, lj) <= 1e-9
    own = [mt._compute_warp_y_online(y_new[:, ld], ld)[2][:-1]
           for ld in range(2)]
    np.testing.assert_array_equal(lt, own[1])
    assert not np.allclose(own[0], own[1])


def test_compute_warp_actual_state_matches_jax():
    y = _stream_data(1)
    out = []
    for cls, kw in ((JaxHDPGPC, {}), (TorchHDPGPC, {"device": "cpu"})):
        m = _online_model(cls, y, "greedy", **kw)
        with contextlib.redirect_stdout(io.StringIO()):
            for i in range(5):
                m.include_sample_fast(X_ON, y[i], with_warp=False,
                                      force_model=i if i < 3 else None)
        n = m.T_count
        q = np.zeros((n, m.M, 1))
        ql = np.zeros((n, m.M, 1))
        xs = np.tile(X_ON, (n, 1))
        with contextlib.redirect_stdout(io.StringIO()):
            q2, ql2, done, y_w = m.compute_warp_actual_state(xs, y[:n], q, ql)
        assert done
        out.append((m, q2, ql2, y_w))
    (mj, qj, qlj, ywj), (mt, qt, qlt, ywt) = out
    for ct, cj in zip(mt.clusters[0], mj.clusters[0]):
        np.testing.assert_array_equal(ct.members, cj.members)
    assert _rel(ywt, ywj) <= 1e-9
    assert _rel(mt.x_w, mj.x_w) <= 1e-9
    assert _rel(mt.liks_w, mj.liks_w) <= 1e-9
    assert _rel(qt, qj) <= 1e-9 and _rel(qlt, qlj) <= 1e-9
    assert not np.allclose(ywt, y[:mt.T_count])
    g = mt.x_w[..., 0] + X_ON
    assert np.all(np.diff(g, axis=1) > 0)
