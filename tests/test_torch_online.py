"""The online path end to end, hdpgpc_tpu against the port, float64, on
the growth stream synthetic_growth_stream(120, 24, 4, seed=7,
start_beat=0, interval=15) with the priors of the growth stress test
(tests/test_stress_growth.py) computed on the stream, K = 8:

* include_sample_fast over the 120 beats: identical partitions after
  every beat, equal M (2), equal caches;
* include_sample over the first 40 beats: the same;
* the port's engine at chunk 1 and 16: the port's include_sample_fast
  partition and hdpgpc_tpu's engine's;
* the classify=True returns and compute_h / baum_welch.

The warp's online cases are in tests/test_torch_warp.py.

The reference's include_sample runs in a subprocess with XLA's backend
optimisation off: jaxlib 0.9.0's optimised CPU build of hmm.backward
under jit has been seen to return wrong messages from about ten beats
on (jit and op-by-op disagree, and the heap is corrupted), which flips
include_sample's decision at beat 20 of this stream. With the
optimisation off the reference equals its own op-by-op evaluation, and
the port equals both. include_sample_fast and the engine never run that
program (only the classify return does, on the fast models of this
file, and agrees)."""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hdpgpc_torch.data.loader import default_x_basis, synthetic_growth_stream
from hdpgpc_torch.models.hdpgpc import HDPGPC as TorchHDPGPC
from hdpgpc_torch.models.stream_online import OnlineStreamEngine as TorchEng
from hdpgpc_tpu.models.hdpgpc import HDPGPC as JaxHDPGPC
from hdpgpc_tpu.models.stream_online import OnlineStreamEngine as JaxEng

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T, K, N, N_IS = 24, 8, 120, 40
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X = np.arange(T, dtype=np.float64)
Y, Z = synthetic_growth_stream(N, T, 4, seed=7, start_beat=0, interval=15)


def _kw(y):
    std = float(np.std(y))
    sd = float(np.std(np.diff(y, axis=0)))
    return dict(n_outputs=1, ini_lengthscale=3.0,
                bound_lengthscale=(1.0, 20.0), ini_gamma=sd, ini_sigma=std,
                ini_outputscale=4.0, bound_sigma=(std * 0.05, std * 0.2),
                bound_gamma=(sd * 0.05, sd * 0.2), verbose=False,
                hmm_switch=True, max_models=K, bayesian_params=True,
                estimation_limit=50, free_deg_MNIV=5,
                compute_dtype="float64")


def _model(cls, y=Y, **kw):
    return cls(default_x_basis(y.shape[1]), **_kw(y), **kw)


def _stream(m, method, n):
    with contextlib.redirect_stdout(io.StringIO()):
        for i in range(n):
            getattr(m, method)(X, Y[i], with_warp=False)
    return m


# the reference's include_sample over N_IS beats, then one classify
# call, compute_h and baum_welch
_JAX_IS = """
import contextlib, dataclasses, io, sys
import numpy as np
sys.path.insert(0, {root!r})
from hdpgpc_tpu.data.loader import default_x_basis
from hdpgpc_tpu.models.hdpgpc import HDPGPC
Y = np.load({path!r} + ".in.npy")
X = np.arange(Y.shape[1], dtype=np.float64)
N_IS = {n_is}
m = HDPGPC(default_x_basis(Y.shape[1]), **{kw!r})
with contextlib.redirect_stdout(io.StringIO()):
    for i in range(N_IS):
        m.include_sample(X, Y[i], with_warp=False)
    cq, cr, _ = m.include_sample(X, Y[N_IS], with_warp=False, classify=True)
bw_pi, bw_trans = m.baum_welch()
m.cfg = dataclasses.replace(m.cfg, hmm_switch=False)
bw0_pi, bw0_trans = m.baum_welch()
out = dict(M=m.M, q_last=m.q_last, q_lat_last=m.q_lat_last,
           resp_last=m.resp_last, respPair_last=m.respPair_last,
           classify_q=cq, classify_resp=cr, h=m.compute_h(),
           bw_pi=np.asarray(bw_pi), bw_trans=np.asarray(bw_trans),
           bw0_pi=np.asarray(bw0_pi), bw0_trans=np.asarray(bw0_trans))
out.update({{f"ra{{i}}": r for i, r in enumerate(m.resp_assigned)}})
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_include_sample(tmp_path_factory):
    """Starts the reference's include_sample in its subprocess before the
    module's first test; ``get()`` waits for it."""
    path = str(tmp_path_factory.mktemp("jax_is") / "out.npz")
    np.save(path + ".in.npy", Y)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    code = _JAX_IS.format(root=ROOT, path=path, n_is=N_IS, kw=_kw(Y))
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    class Handle:
        out = None

        def get(self):
            if self.out is None:
                _so, se = proc.communicate(timeout=600)
                assert proc.returncode == 0, se[-3000:]
                self.out = dict(np.load(path))
            return self.out

    yield Handle()
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def fast_pair():
    return (_stream(_model(TorchHDPGPC, device="cpu"),
                    "include_sample_fast", N),
            _stream(_model(JaxHDPGPC), "include_sample_fast", N))


@pytest.fixture(scope="module")
def port_include_sample():
    return _stream(_model(TorchHDPGPC, device="cpu"), "include_sample", N_IS)


@pytest.fixture(scope="module")
def jax_engine_labels():
    eng = JaxEng(_model(JaxHDPGPC), K=K, chunk=1)
    with contextlib.redirect_stdout(io.StringIO()):
        eng.run(Y)
    return eng.labels()


def _caches_equal(mt, get):
    for f in ("q_last", "q_lat_last", "resp_last", "respPair_last"):
        a, b = getattr(mt, f), get(f)
        assert a.shape == b.shape, f
        f_ = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), f_), f
        assert np.max(np.abs(a[f_] - b[f_])) <= 1e-9 * np.max(
            np.abs(b[f_])), f


def test_include_sample_fast_matches_jax(fast_pair):
    mt, mj = fast_pair
    assert mt.M == mj.M == 2
    assert len(mt.resp_assigned) == len(mj.resp_assigned) == N
    for a, b in zip(mt.resp_assigned, mj.resp_assigned):
        np.testing.assert_array_equal(a, b)
    for ct, cj in zip(mt.clusters[0], mj.clusters[0]):
        np.testing.assert_array_equal(ct.members, cj.members)
    _caches_equal(mt, lambda f: getattr(mj, f))


def test_include_sample_matches_jax(jax_include_sample, port_include_sample):
    ref = jax_include_sample.get()
    mt = port_include_sample
    assert mt.M == int(ref["M"]) >= 2
    assert len(mt.resp_assigned) == N_IS
    for i, a in enumerate(mt.resp_assigned):
        np.testing.assert_array_equal(a, ref[f"ra{i}"])
    _caches_equal(mt, ref.__getitem__)
    # classify=True scores one more beat without committing it
    with contextlib.redirect_stdout(io.StringIO()):
        cq, cr, liks = mt.include_sample(X, Y[N_IS], with_warp=False,
                                         classify=True)
    assert mt.T_count == N_IS and liks.shape == (mt.M,)
    np.testing.assert_array_equal(cr, ref["classify_resp"])
    f_ = np.isfinite(ref["classify_q"])
    np.testing.assert_allclose(cq[f_], ref["classify_q"][f_], rtol=1e-9)


def test_include_sample_fast_classify_matches_jax(fast_pair):
    mt, mj = fast_pair
    y_new = synthetic_growth_stream(1, T, 4, seed=8, start_beat=N,
                                    interval=15)[0][0]
    with contextlib.redirect_stdout(io.StringIO()):
        qt, rt, lt = mt.include_sample_fast(X, y_new, with_warp=False,
                                            classify=True)
        qj, rj, lj = mj.include_sample_fast(X, y_new, with_warp=False,
                                            classify=True)
    assert mt.T_count == N
    np.testing.assert_array_equal(rt, np.asarray(rj))
    np.testing.assert_array_equal(lt, lj)
    f_ = np.isfinite(qj)
    np.testing.assert_allclose(qt[f_], qj[f_], rtol=1e-9)


@pytest.mark.parametrize("chunk", [1, 16])
def test_engine_matches_fast_path_and_jax(chunk, fast_pair,
                                          jax_engine_labels):
    mt, _mj = fast_pair
    eng = TorchEng(_model(TorchHDPGPC, device="cpu"), K=K, chunk=chunk)
    with contextlib.redirect_stdout(io.StringIO()):
        uids = eng.run(Y)
    assert uids.shape == (N,) and sum(eng.births) == 1
    assert int(eng.carry.M) == mt.M
    np.testing.assert_array_equal(eng.labels(), mt.resp_assigned[-1])
    np.testing.assert_array_equal(eng.labels(), jax_engine_labels)
    assert np.isfinite(float(eng.carry.q_sel_sum))
    assert np.isfinite(float(eng.carry.qlat_sel_sum))


def test_compute_h_and_baum_welch_match_jax(jax_include_sample,
                                           port_include_sample):
    """compute_h / baum_welch (GPI_HDP.py:3824-3931) after the
    include_sample stream."""
    ref = jax_include_sample.get()
    mt = port_include_sample
    h = mt.compute_h()
    np.testing.assert_allclose(h, ref["h"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.exp(h).sum(axis=1), 1.0, rtol=1e-8)
    np.testing.assert_array_equal(mt.compute_h(time=2), h[2])
    pi_, trans = mt.baum_welch()
    assert pi_.shape == (mt.M,) and trans.shape == (mt.M, mt.M)
    np.testing.assert_allclose(pi_, ref["bw_pi"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(trans, ref["bw_trans"], rtol=1e-9,
                               atol=1e-12)
    # hmm_switch=False: the current pis, unchanged (GPI_HDP.py:3930)
    cfg = mt.cfg
    mt.cfg = dataclasses.replace(cfg, hmm_switch=False)
    try:
        pi0, tr0 = mt.baum_welch()
    finally:
        mt.cfg = cfg
    np.testing.assert_array_equal(pi0, ref["bw0_pi"])
    np.testing.assert_array_equal(tr0, ref["bw0_trans"])
