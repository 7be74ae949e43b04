"""The port's ``gram`` on (T, D) input grids against hdpgpc_tpu's, on the
CPU in float64: D = 1, 2 and 3, one argument (the noise on the
diagonal) and two (none, unless asked), to 1e-12 relative. Kernel A on
the card at D > 1 is in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch.ops import kernels as tk
from hdpgpc_tpu.ops import kernels as jk

THETA = (300.0, 1.7, 0.05)


def _grids(T1, T2, D, seed):
    rng = np.random.default_rng(seed)
    shape1 = (T1,) if D == 1 else (T1, D)
    shape2 = (T2,) if D == 1 else (T2, D)
    return rng.uniform(0, 6, shape1), rng.uniform(0, 6, shape2)


def _rel(a, b):
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-30 * THETA[0])))


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("two_args", [False, True])
@pytest.mark.parametrize("include_noise", [None, True, False])
def test_gram_nd_matches_jax(D, two_args, include_noise):
    x1, x2 = _grids(13, 9, D, 10 * D)
    if not two_args:
        x2 = None
    pj = jk.KernelParams(*[jnp.asarray(v) for v in THETA])
    pt = tk.KernelParams(*[torch.tensor(v, dtype=torch.float64)
                           for v in THETA])
    if x2 is not None and include_noise:
        x2 = x1.copy()          # the noise needs a square Gram
    Kj = np.asarray(jk.gram(pj, jnp.asarray(x1),
                            None if x2 is None else jnp.asarray(x2),
                            include_noise=include_noise))
    Kt = tk.gram(pt, torch.tensor(x1),
                 None if x2 is None else torch.tensor(x2),
                 include_noise=include_noise).numpy()
    assert Kt.shape == Kj.shape
    assert _rel(Kt, Kj) <= 1e-12


def test_gram_column_grid_equals_flat_grid():
    """A (T, 1) grid and the flat (T,) grid give the same bits."""
    x = np.arange(11, dtype=np.float64) * 0.7
    pt = tk.KernelParams(*[torch.tensor(v, dtype=torch.float64)
                           for v in THETA])
    a = tk.gram(pt, torch.tensor(x)).numpy()
    b = tk.gram(pt, torch.tensor(x[:, None])).numpy()
    np.testing.assert_array_equal(a, b)


def test_rbf_gram_rejects_grids_of_two_widths():
    """Grids of different D do not broadcast into a Gram (the card path
    checks it before launching; on the CPU the plain version raises)."""
    x1 = torch.zeros(4, 2, dtype=torch.float64)
    x2 = torch.zeros(5, 3, dtype=torch.float64)
    with pytest.raises(RuntimeError):
        tk.fused_rbf_gram(x1, x2, 1.0, 1.0)
