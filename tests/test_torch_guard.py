"""The port's float32 speed-mode helpers: amplitude normalisation
(_maybe_normalise_f32) against hdpgpc_tpu, and the three on_fragile
actions of the fragility guard."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from hdpgpc_torch.models.hdpgpc import HDPGPC as TorchHDPGPC
from hdpgpc_tpu.data.loader import default_x_basis, synthetic_beats
from hdpgpc_tpu.data.priors import compute_estimators_lds
from hdpgpc_tpu.models.hdpgpc import HDPGPC as JaxHDPGPC

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T, N = 24, 40


def _model(cls, y, **kw):
    std, std_dif, bs, bg = compute_estimators_lds(y)
    m = cls(default_x_basis(T), n_outputs=1, ini_gamma=std_dif,
            ini_sigma=std, ini_outputscale=10.0, bound_sigma=bs,
            bound_gamma=bg, max_models=100, reestimate_initial_params=True,
            n_explore_steps=2, compute_dtype="float32", **kw)
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters=200, kernel_fit_iters_f32=200))
    return m


def _run(m, y):
    x = np.tile(np.arange(T, dtype=np.float64), (N, 1))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m.include_batch(x, y, with_warp=False)
    return buf.getvalue()


def _beats(scale):
    y, _ = synthetic_beats(N, T=T, n_clusters=2, noise=0.03, seed=1)
    return y * scale


def test_normalise_f32_matches_jax():
    """Large amplitudes (std > 8) are normalised in float32 mode, with
    the variance-like priors rescaled by s^2, as in the reference."""
    y = _beats(40.0)
    mt, mj = _model(TorchHDPGPC, y), _model(JaxHDPGPC, y)
    yt = mt._maybe_normalise_f32(y.copy())
    yj = mj._maybe_normalise_f32(y.copy())
    np.testing.assert_array_equal(yt, yj)
    assert mt._y_scale == mj._y_scale != 1.0
    for f in ("_def_sigma", "_def_gamma", "_def_outputscale",
              "_def_bound_sigma", "_def_bound_gamma"):
        assert getattr(mt, f) == getattr(mj, f), f
    np.testing.assert_array_equal(mt.clusters[0][0].state.K0.numpy(),
                                  np.asarray(mj.clusters[0][0].state.K0))


@pytest.mark.parametrize("action", ["warn", "raise", "fallback_f64"])
def test_on_fragile_actions(action):
    """f32_guard_tol=1.0 makes every structural decision fragile, so the
    guard fires at the end of the sweep."""
    y = _beats(1.0)
    m = _model(TorchHDPGPC, y)
    m.cfg = dataclasses.replace(m.cfg, f32_guard_tol=1.0, on_fragile=action)
    if action == "raise":
        with pytest.raises(FloatingPointError):
            _run(m, y)
        return
    out = _run(m, y)
    if action == "warn":
        assert m.f32_fragile and "WARNING" in out
        assert m.dtype == torch.float32
    else:
        assert m.f32_fallback is not None
        assert m.dtype == torch.float64 and not m.f32_fragile
        assert m.clusters[0][0].state.A.dtype == torch.float64
    assert np.isfinite(m.train_elbo).all()
