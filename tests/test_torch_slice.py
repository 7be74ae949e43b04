"""The offline sweep end to end: hdpgpc_tpu's include_batch against the
port's, float64, on synthetic beats (T=24, N=60, K=3, a 300-step
kernel-fit budget, as tests/test_offline_e2e.py). The partitions must
be identical in every sweep, M equal, and the ELBO history equal to
1e-8 relative."""

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

T, N, K = 24, 60, 3


def _sweep(cls, y, est_limit, dtype="float64"):
    std, std_dif, bs, bg = compute_estimators_lds(y)
    m = cls(default_x_basis(T), n_outputs=y.shape[2], ini_lengthscale=3.0,
            bound_lengthscale=(1.0, 20.0), ini_gamma=std_dif, ini_sigma=std,
            ini_outputscale=10.0, bound_sigma=bs, bound_gamma=bg,
            hmm_switch=True, max_models=100, bayesian_params=True,
            reestimate_initial_params=True, n_explore_steps=3,
            free_deg_MNIV=5, estimation_limit=est_limit,
            compute_dtype=dtype, device="cpu")
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters=300))
    x = np.tile(np.arange(T, dtype=np.float64), (y.shape[0], 1))
    with contextlib.redirect_stdout(io.StringIO()):
        m.include_batch(x, y, with_warp=False)
    return m


@pytest.mark.parametrize("leads,est_limit", [(1, None), (2, None), (1, 20)])
def test_include_batch_matches_jax(leads, est_limit):
    y, z = synthetic_beats(N, T=T, n_clusters=K, n_outputs=leads,
                           noise=0.03, seed=0)
    mj = _sweep(JaxHDPGPC, y, est_limit)
    mt = _sweep(TorchHDPGPC, y, est_limit)
    assert mt.M == mj.M
    assert len(mt.resp_assigned) == len(mj.resp_assigned)
    for a, b in zip(mt.resp_assigned, mj.resp_assigned):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(mt.train_elbo, mj.train_elbo, rtol=1e-8)
    for ct, cj in zip(mt.clusters[0], mj.clusters[0]):
        np.testing.assert_array_equal(ct.members, cj.members)
    # the sweep found the generating clusters
    lab = mt.resp_assigned[-1]
    err = sum(int(np.sum(z[lab == m] != np.bincount(z[lab == m]).argmax()))
              for m in np.unique(lab))
    assert err / N < 0.15
