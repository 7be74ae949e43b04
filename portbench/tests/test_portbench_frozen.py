"""The yardstick's frozen copies give today's program's arrays and
numbers exactly."""

import numpy as np
import pytest
import torch

from hdpgpc_torch.data import loader, priors
from hdpgpc_torch.utils import kernel_timing as kt
from portbench.frozen import data as fdata
from portbench.frozen import priors as fpriors
from portbench.frozen import roofline as froof


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_synthetic_beats(seed):
    a = loader.synthetic_beats(300, T=90, n_clusters=4, noise=0.05,
                               seed=seed)
    b = fdata.synthetic_beats(300, T=90, n_clusters=4, noise=0.05,
                              seed=seed)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("seed,start,interval", [(7, 0, 64),
                                                 (2 ** 33, 320, 64),
                                                 (3, 100, 200)])
def test_growth_stream(seed, start, interval):
    a = loader.synthetic_growth_stream(500, 90, 4, seed, start, interval)
    b = fdata.synthetic_growth_stream(500, 90, 4, seed, start, interval)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert np.array_equal(loader.growth_templates(90, 8),
                          fdata.growth_templates(90, 8))


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 1])
def test_fixed_morphology_beats(seed):
    """synthetic_beats' record of morph_seed, with other noise."""
    y, z = fdata.fixed_morphology_beats(400, 90, 4, 0.05, 0, seed)
    ys, zs = fdata.synthetic_beats(400, 90, 4, noise=0.05, seed=0)
    y0, _ = fdata.fixed_morphology_beats(400, 90, 4, 0.0, 0, seed)
    t0, _ = fdata.synthetic_beats(400, 90, 4, noise=0.0, seed=0)
    assert np.array_equal(z, zs) and np.allclose(y0, t0, atol=1e-12)
    assert not np.allclose(y, ys)


@pytest.mark.parametrize("seed", [0, 5])
def test_priors(seed):
    y, _ = loader.synthetic_beats(500, T=90, seed=seed)
    assert priors.compute_estimators_lds(y) \
        == fpriors.compute_estimators_lds(y)
    g, _ = loader.synthetic_growth_stream(800, 90, 4, seed, 0, 64)
    assert priors.compute_estimators_lds(g[:, :, None]) \
        == fpriors.compute_estimators_lds(g[:, :, None])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16, 90, 90), (64, 90, 90),
                                   (256, 90, 90), (64, 90, 2019)])
def test_rooflines(dtype, shape):
    name = "float32" if dtype == torch.float32 else "float64"
    assert kt.spd_solve_bound(*shape, dtype) \
        == froof.spd_solve_bound(*shape, name)
    assert kt.rbf_gram_bound(shape[1], shape[2], dtype, D=2) \
        == froof.rbf_gram_bound(shape[1], shape[2], name, D=2)
    assert kt.PEAK_BYTES_PER_S == froof.PEAK_BYTES_PER_S
    assert kt.PEAK_OPS_PER_S[dtype] == froof.PEAK_OPS_PER_S[name]
