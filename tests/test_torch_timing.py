"""The phase timers (HDPGPC_TIMING=1), warmup_programs and the profiler
hooks of utils/metrics.py, on a short synthetic sweep (T = 24, N = 40,
float64, on the CPU):

* the timer keys after the sweep equal hdpgpc_tpu's after the same
  sweep, and the timings sum to no more than the sweep's wall time;
* the partitions are identical with and without the timers, and after
  warmup_programs;
* debug_nans raises on the first op that makes a NaN; trace writes a
  trace."""

import contextlib
import dataclasses
import io
import os
import time

import numpy as np
import pytest
import torch

from hdpgpc_torch.models.hdpgpc import HDPGPC as TorchHDPGPC
from hdpgpc_torch.utils.metrics import debug_nans, trace
from hdpgpc_tpu.data.loader import default_x_basis, synthetic_beats
from hdpgpc_tpu.data.priors import compute_estimators_lds
from hdpgpc_tpu.models.hdpgpc import HDPGPC as JaxHDPGPC

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T, N = 24, 40
KEYS = {"refit_batch", "refit_one", "seed_score", "fb", "kernel_fit",
        "q_elbo", "hdp_update", "warp"}
Y, Z = synthetic_beats(N, T=T, n_clusters=3, noise=0.03, seed=0)


def _model(cls, **kw):
    std, std_dif, bs, bg = compute_estimators_lds(Y)
    m = cls(default_x_basis(T), n_outputs=1, ini_lengthscale=3.0,
            bound_lengthscale=(1.0, 20.0), ini_gamma=std_dif, ini_sigma=std,
            ini_outputscale=10.0, bound_sigma=bs, bound_gamma=bg,
            hmm_switch=True, max_models=100, bayesian_params=True,
            reestimate_initial_params=True, n_explore_steps=3,
            free_deg_MNIV=5, compute_dtype="float64", **kw)
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters=300))
    return m


def _sweep(m):
    x = np.tile(np.arange(T, dtype=np.float64), (N, 1))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        m.include_batch(x, Y, with_warp=False)
    return time.perf_counter() - t0


@pytest.fixture(scope="module")
def untimed():
    m = _model(TorchHDPGPC, device="cpu")
    _sweep(m)
    return m


def test_timer_keys_match_jax(monkeypatch, untimed):
    monkeypatch.setenv("HDPGPC_TIMING", "1")
    mj = _model(JaxHDPGPC)
    _sweep(mj)
    mt = _model(TorchHDPGPC, device="cpu")
    wall = _sweep(mt)
    assert set(mt.timings) == set(mj.timings)
    assert set(mt.timings) <= KEYS and set(mt.counts) == set(mt.timings)
    assert all(v >= 0.0 for v in mt.timings.values())
    assert sum(mt.timings.values()) <= wall
    assert not mt._timing_stack
    # the timers change no decision
    assert mt.M == untimed.M
    for a, b in zip(mt.resp_assigned, untimed.resp_assigned, strict=True):
        np.testing.assert_array_equal(a, b)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mt.print_timings()
    assert "[time] total tracked" in out.getvalue()
    assert "[memo] refit hits/misses" in out.getvalue()


def test_untimed_model_keeps_no_timings(monkeypatch, untimed):
    monkeypatch.delenv("HDPGPC_TIMING", raising=False)
    assert untimed.timings == {} and untimed.counts == {}


def test_warmup_programs_changes_no_partition(untimed):
    m = _model(TorchHDPGPC, device="cpu")
    m.warmup_programs(N)
    assert m._memo_stats == [0, 0] and m.timings == {}
    _sweep(m)
    assert m.M == untimed.M
    for a, b in zip(m.resp_assigned, untimed.resp_assigned, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(m.train_elbo, untimed.train_elbo)


def test_debug_nans_raises_on_the_first_nan():
    x = torch.tensor([0.0, 1.0], dtype=torch.float64)
    with debug_nans():
        y = x * 2.0
        with pytest.raises(FloatingPointError, match="NaN"):
            x / x
    with debug_nans(False):
        z = x / x
    assert torch.isnan(z[0]) and y[1] == 2.0


def test_trace_and_timer(tmp_path):
    # the profiler hook (the wall-clock lap timer it was tested with is
    # gone: the phase timers and the span recorder time the program)
    with trace(str(tmp_path)):
        torch.ones(8, dtype=torch.float64).cumsum(0)
    assert os.path.getsize(tmp_path / "trace.json") > 0
