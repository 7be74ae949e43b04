"""The supervised path against hdpgpc_tpu, float64 on the CPU:
reload_model_from_labels on 60 labelled synthetic beats, then
cluster_new_batch on 20 new ones without learning and with learning
(it_limit=2), at 1 and 2 leads (T = 24, K = 3, a 300-step kernel-fit
budget, as tests/test_offline_e2e.py). Labels and partitions must be
identical, M equal and the ELBO history equal to 1e-9 relative.
compute_Pi and compute_joint_xy_q are compared too."""

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

T, N_TRAIN, N_NEW, K = 24, 60, 20, 3


def _model(cls, y, leads):
    std, std_dif, bs, bg = compute_estimators_lds(y)
    kw = {"device": "cpu"} if cls is TorchHDPGPC else {}
    m = cls(default_x_basis(T), n_outputs=leads, ini_lengthscale=3.0,
            bound_lengthscale=(1.0, 20.0), ini_gamma=std_dif, ini_sigma=std,
            ini_outputscale=10.0, bound_sigma=bs, bound_gamma=bg,
            hmm_switch=True, max_models=100, bayesian_params=True,
            reestimate_initial_params=False, n_explore_steps=3,
            free_deg_MNIV=5, compute_dtype="float64", **kw)
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters=300))
    return m


def _run(cls, leads):
    y, z = synthetic_beats(N_TRAIN + N_NEW, T=T, n_clusters=K,
                           n_outputs=leads, noise=0.03, seed=0)
    x = np.tile(np.arange(T, dtype=np.float64), (N_TRAIN, 1))
    m = _model(cls, y[:N_TRAIN], leads)
    out = {}
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        m.reload_model_from_labels(x, y[:N_TRAIN], z[:N_TRAIN], M=K)
        out["reload_elbo"] = list(m.train_elbo)
        out["reload"] = m.resp_assigned[-1].copy()
        out["f_ind_old"] = m.f_ind_old.copy()
        out["Pi"] = m.compute_Pi()
        if leads == 2:
            out["joint"] = m.compute_joint_xy_q(y)
            out["joint_rho"] = m.compute_joint_xy_q(
                y, rho_xy=np.linspace(-0.5, 0.5, K))
        out["new"] = m.cluster_new_batch(x[:N_NEW], y[N_TRAIN:])
        out["learn"] = m.cluster_new_batch(x[:N_NEW], y[N_TRAIN:],
                                           learning=True, it_limit=2)
    out["printed"] = buf.getvalue()
    return m, out, z


@pytest.mark.parametrize("leads", [1, 2])
def test_reload_and_classify_match_jax(leads):
    mj, oj, z = _run(JaxHDPGPC, leads)
    mt, ot, _ = _run(TorchHDPGPC, leads)
    for k in ("reload", "f_ind_old", "new", "learn"):
        np.testing.assert_array_equal(ot[k], oj[k], err_msg=k)
    np.testing.assert_allclose(ot["reload_elbo"], oj["reload_elbo"],
                               rtol=1e-9)
    assert "-------ELBO:" in ot["printed"]
    np.testing.assert_allclose(ot["Pi"], oj["Pi"], rtol=1e-12)
    if leads == 2:
        np.testing.assert_allclose(ot["joint"], oj["joint"], rtol=1e-9)
        np.testing.assert_allclose(ot["joint_rho"], oj["joint_rho"],
                                   rtol=1e-9)
        assert not np.allclose(ot["joint"], ot["joint_rho"])
    assert mt.M == mj.M
    assert len(mt.resp_assigned) == len(mj.resp_assigned)
    for a, b in zip(mt.resp_assigned, mj.resp_assigned):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(mt.train_elbo, mj.train_elbo, rtol=1e-9)
    for ct, cj in zip(mt.clusters[0], mj.clusters[0]):
        np.testing.assert_array_equal(ct.members, cj.members)
    # the labelled clusters classify the new beats
    assert np.mean(ot["new"] == z[N_TRAIN:]) > 0.9
