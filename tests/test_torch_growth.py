"""The growth stress (BASELINE config 5's ``--grow`` half) through the
port's fused online engine, on the CPU:

* the properties tests/test_stress_growth.py pins on hdpgpc_tpu, at a
  CPU size (T = 24, K = 12 slots, 8 morphologies, 2,000 beats in blocks
  of 500, float32, estimation_limit=50): births after the first quarter,
  M >= morphologies - 2, M <= K, the carry's bytes constant, majority
  accuracy >= 0.85;
* the engine at K = 64 slots against hdpgpc_tpu's, float64, chunk 1, on
  synthetic_growth_stream(300, 24, 6, seed=7, interval=50) with the
  example's model (estimation_limit=100, priors from the stream's first
  50 beats, which hold one morphology): identical labels, M and births
  (4), the accounting sums to 1e-9 relative.

The reference's engine runs in a subprocess with XLA's backend
optimisation off (jaxlib 0.9.0's optimised CPU build miscompiles some
jitted HMM programs; ROADMAP C), started when the module is set up so
that it runs beside the port's half.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hdpgpc_torch import convert
from hdpgpc_torch.data.loader import default_x_basis, synthetic_growth_stream
from hdpgpc_torch.models.hdpgpc import HDPGPC
from hdpgpc_torch.models.stream_online import OnlineStreamEngine

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 24
# the properties run
K_SMALL, N_CLUSTERS, BEATS, BLOCK = 12, 8, 2000, 500
# the parity run at K = 64 slots
K_WIDE, PARITY = 64, dict(n=300, T=T, n_clusters=6, seed=7, start_beat=0,
                          interval=50)
PARITY_WARM = 50


def _kw(warm, K, est, dtype):
    """examples/run_stress_stream.py's growth model, priors from
    ``warm``."""
    std = float(np.std(warm))
    sd = float(np.std(np.diff(warm, axis=0)))
    return dict(n_outputs=1, ini_lengthscale=3.0,
                bound_lengthscale=(1.0, 20.0), ini_gamma=sd, ini_sigma=std,
                ini_outputscale=4.0, bound_sigma=(std * 0.05, std * 0.2),
                bound_gamma=(sd * 0.05, sd * 0.2), verbose=False,
                hmm_switch=True, max_models=K, bayesian_params=True,
                estimation_limit=est, free_deg_MNIV=5, compute_dtype=dtype)


_JAX_ENGINE = """
import contextlib, io, sys
import numpy as np
sys.path.insert(0, {root!r})
from hdpgpc_tpu.data.loader import default_x_basis
from hdpgpc_tpu.models.hdpgpc import HDPGPC
from hdpgpc_tpu.models.stream_online import OnlineStreamEngine
Y = np.load({path!r} + ".in.npy")
m = HDPGPC(default_x_basis(Y.shape[1]), **{kw!r})
eng = OnlineStreamEngine(m, K={K}, chunk=1)
with contextlib.redirect_stdout(io.StringIO()):
    eng.run(Y)
np.savez({path!r}, labels=eng.labels(), births=np.asarray(eng.births),
         M=int(eng.carry.M), q_sel_sum=float(eng.carry.q_sel_sum),
         qlat_sel_sum=float(eng.carry.qlat_sel_sum))
"""


def _parity_stream():
    y, _z = synthetic_growth_stream(**PARITY)
    return y, _kw(y[:PARITY_WARM], K_WIDE, 100, "float64")


@pytest.fixture(scope="module", autouse=True)
def jax_engine(tmp_path_factory):
    """Starts hdpgpc_tpu's engine on the parity stream in its subprocess
    before the module's first test; ``get()`` waits for it."""
    path = str(tmp_path_factory.mktemp("jax_growth") / "out.npz")
    y, kw = _parity_stream()
    np.save(path + ".in.npy", y)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_ENGINE.format(root=ROOT, path=path,
                                                  kw=kw, K=K_WIDE)],
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


def _carry_bytes(carry) -> int:
    return sum(x.numel() * x.element_size()
               for x in convert.tree_leaves(carry))


def test_growth_stress_properties():
    interval = BEATS // N_CLUSTERS

    def stream(n, start, seed):
        return synthetic_growth_stream(n, T, N_CLUSTERS, seed=seed,
                                       start_beat=start, interval=interval)
    warm, _ = stream(256, 0, 7)
    model = HDPGPC(default_x_basis(T), device="cpu",
                   **_kw(warm, K_SMALL, 50, "float32"))
    eng = OnlineStreamEngine(model, K=K_SMALL, chunk=BLOCK)
    done, z_all = 0, []
    born_at_quarter = bytes_at_quarter = None
    with contextlib.redirect_stdout(io.StringIO()):
        while done < BEATS:
            y, z = stream(BLOCK, done, 100 + done)
            eng.run(y, hdp_refresh=True)
            z_all.append(z)
            done += BLOCK
            if born_at_quarter is None and done >= BEATS // 4:
                born_at_quarter = int(eng.carry.M)
                bytes_at_quarter = _carry_bytes(eng.carry)
    z_all = np.concatenate(z_all)
    M = int(eng.carry.M)
    # births after the first quarter, enough of them, within the slots
    assert M > born_at_quarter >= 1
    assert M >= N_CLUSTERS - 2, f"only {M} clusters born for 8 morphologies"
    assert M <= K_SMALL
    # the K-slot carry does not grow with beats or births
    assert _carry_bytes(eng.carry) == bytes_at_quarter
    uids = np.asarray(eng.uids)
    correct = sum(int(np.bincount(z_all[uids == u]).max())
                  for u in np.unique(uids))
    assert correct / BEATS >= 0.85, f"majority accuracy {correct / BEATS}"
    assert np.isfinite(float(eng.carry.q_sel_sum))
    assert np.isfinite(float(eng.carry.qlat_sel_sum))


def test_engine_at_64_slots_matches_jax(jax_engine):
    y, kw = _parity_stream()
    eng = OnlineStreamEngine(HDPGPC(default_x_basis(T), device="cpu", **kw),
                             K=K_WIDE, chunk=1)
    with contextlib.redirect_stdout(io.StringIO()):
        eng.run(y)
    ref = jax_engine.get()
    assert int(eng.carry.M) == int(ref["M"]) == 5
    np.testing.assert_array_equal(np.asarray(eng.births), ref["births"])
    assert sum(eng.births) == 4
    np.testing.assert_array_equal(eng.labels(), ref["labels"])
    for f in ("q_sel_sum", "qlat_sel_sum"):
        a, b = float(getattr(eng.carry, f)), float(ref[f])
        assert abs(a - b) <= 1e-9 * abs(b), f
