"""utils/plots.py of the port: cluster_kl_matrix against hdpgpc_tpu's on
fitted models (float64, the same short synthetic sweep in both
packages, whose partitions are identical: tests/test_torch_slice.py),
and every plot rendered to an Agg PNG. Skips without matplotlib."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from hdpgpc_torch.models.hdpgpc import HDPGPC as TorchHDPGPC
from hdpgpc_torch.utils import plots as tp
from hdpgpc_tpu.data.loader import default_x_basis, synthetic_beats
from hdpgpc_tpu.data.priors import compute_estimators_lds
from hdpgpc_tpu.models.hdpgpc import HDPGPC as JaxHDPGPC
from hdpgpc_tpu.utils import plots as jp

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T, N = 24, 40
Y, Z = synthetic_beats(N, T=T, n_clusters=3, noise=0.03, seed=0)


def _fit(cls, **kw):
    std, std_dif, bs, bg = compute_estimators_lds(Y)
    m = cls(default_x_basis(T), n_outputs=1, ini_lengthscale=3.0,
            bound_lengthscale=(1.0, 20.0), ini_gamma=std_dif, ini_sigma=std,
            ini_outputscale=10.0, bound_sigma=bs, bound_gamma=bg,
            hmm_switch=True, max_models=100, bayesian_params=True,
            reestimate_initial_params=True, n_explore_steps=3,
            free_deg_MNIV=5, compute_dtype="float64", **kw)
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters=300))
    x = np.tile(np.arange(T, dtype=np.float64), (N, 1))
    with contextlib.redirect_stdout(io.StringIO()):
        m.include_batch(x, Y, with_warp=False)
    return m


@pytest.fixture(scope="module")
def models():
    return _fit(TorchHDPGPC, device="cpu"), _fit(JaxHDPGPC)


def test_cluster_kl_matrix_matches_jax(models):
    mt, mj = models
    assert mt.selected_gpmodels() == mj.selected_gpmodels()
    Dt = tp.cluster_kl_matrix(mt)
    Dj = jp.cluster_kl_matrix(mj)
    assert Dt.shape == Dj.shape and Dt.shape[0] >= 2
    assert np.max(np.abs(Dt - Dj)) <= 1e-8 * np.max(np.abs(Dj))
    np.testing.assert_array_equal(Dt, Dt.T)


@pytest.mark.parametrize("name", ["models", "models_plotly", "mds", "warp",
                                  "ecg", "comparison"])
def test_plots_render(models, tmp_path, name):
    pytest.importorskip("matplotlib")
    mt, _ = models
    path = str(tmp_path / f"{name}.png")
    sel = mt.selected_gpmodels()
    x = np.arange(T, dtype=np.float64)
    if name == "models":
        out = tp.plot_models(mt, sel, None, Z, save=path, plot_latent=True)
    elif name == "models_plotly":
        out = tp.plot_models_plotly(mt, sel, ["a"] * len(sel), Z, save=path)
    elif name == "mds":
        pytest.importorskip("sklearn")
        out = tp.plot_mds(mt, save=path)
    elif name == "warp":
        out = tp.plot_warp(x, torch.zeros(3, T, dtype=torch.float64),
                           save=path)
    elif name == "ecg":
        out = tp.plot_ecg(Y, labels=Z, save=path)
    else:
        out = tp.plot_comparison(Y[:3, :, 0], torch.tensor(Y[3:6, :, 0]),
                                 save=path)
    assert out == path
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
