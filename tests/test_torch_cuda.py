"""The two hand-written CUDA kernels against their plain versions on the
card. Marked ``gpu``; each test skips (with the reason) where torch sees
no CUDA device. Run on the card with
``python -m pytest -m gpu tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

from hdpgpc_torch.ops.kernels import fused_rbf_gram, rbf_gram
from hdpgpc_torch.ops.spd_solve import spd_solve, spd_solve_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _spd(n, T, seed, cond=5.0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, T, T))
    spd = (M @ M.transpose(0, 2, 1) + cond * np.eye(T)) * 37.0
    return spd, rng.standard_normal((n, T, T)) * 12.0


@pytest.mark.parametrize("n,T,R", [(16, 90, 90), (8, 128, 128), (3, 5, 2),
                                   (40, 33, 70), (2, 128, 300)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-3)])
def test_spd_solve_kernel_matches_plain(cuda, n, T, R, dtype, tol):
    """max |X - X_plain| / (|X_plain| + 1e-3) on well-conditioned
    systems: 1e-10 in float64, 2e-3 in float32."""
    spd, rhs = _spd(n, T, n + T)
    rhs = np.ascontiguousarray(np.resize(rhs, (n, T, R)))
    a = torch.tensor(spd, dtype=dtype, device=cuda)
    b = torch.tensor(rhs, dtype=dtype, device=cuda)
    before = spd_solve.launches
    X = spd_solve(a, b)
    torch.cuda.synchronize()
    assert spd_solve.launches == before + 1
    Xp = spd_solve_plain(a, b)
    err = ((X - Xp).abs() / (Xp.abs() + 1e-3)).max().item()
    assert err < tol


def test_spd_solve_kernel_nan_on_failure_and_checks(cuda):
    spd, rhs = _spd(4, 20, 0)
    spd[2] = -spd[2]
    a = torch.tensor(spd, device=cuda)
    b = torch.tensor(rhs, device=cuda)
    X = spd_solve(a, b).cpu().numpy()
    assert np.isnan(X[2]).all() and np.isfinite(np.delete(X, 2, 0)).all()
    # the kernel's own limit, which the wrapper reads
    from hdpgpc_torch.ops import _build
    assert _build.load().spd_solve_max_t() == 128
    with pytest.raises(ValueError):
        spd_solve(torch.zeros((1, 129, 129), device=cuda, dtype=torch.float64),
                  torch.zeros((1, 129, 129), device=cuda,
                              dtype=torch.float64))
    with pytest.raises(ValueError):
        spd_solve(a.transpose(1, 2), b)
    with pytest.raises(TypeError):
        spd_solve(a.float(), b)


@pytest.mark.parametrize("T1,T2", [(90, 90), (256, 256), (7, 300)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-6)])
def test_rbf_gram_kernel_matches_plain(cuda, T1, T2, dtype, tol):
    x1 = torch.linspace(0, T1 - 1, T1, dtype=dtype, device=cuda)
    x2 = torch.linspace(-3, T2 + 2, T2, dtype=dtype, device=cuda)
    c = torch.tensor(300.0, dtype=dtype, device=cuda)
    ls = torch.tensor(1.2, dtype=dtype, device=cuda)
    before = fused_rbf_gram.launches
    K = fused_rbf_gram(x1, x2, c, ls)
    torch.cuda.synchronize()
    assert fused_rbf_gram.launches == before + 1
    Kp = rbf_gram(x1, x2, c, ls)
    rel = ((K - Kp).abs() / (Kp.abs() + 1e-30 * 300.0)).max().item()
    assert rel <= tol


def test_refit_on_card_matches_cpu(cuda):
    """One float64 refit through kernel B on the card against the CPU
    (plain) refit: scores to 1e-9 relative."""
    from hdpgpc_torch.models import gplds
    from hdpgpc_torch.ops.kernels import KernelParams
    T, N = 30, 50
    rng = np.random.default_rng(9)
    Y = np.sin(np.linspace(0, 6, T))[None] + 0.1 * rng.standard_normal(
        (N, T))
    resp = (np.arange(N) % 3 == 0).astype(np.float64)
    out = {}
    for dev in ("cpu", cuda):
        th = KernelParams(1.5, 2.0, 0.05)
        st = gplds.init_cluster_state(
            torch.arange(T, dtype=torch.float64, device=dev), th, 0.02, 0.1,
            5.0)
        r = gplds.build_refit(T, est_limit=8, free_deg=5.0)(
            torch.tensor(Y, device=dev), torch.tensor(resp, device=dev), st)
        out[str(dev)] = r
    a, b = out["cuda"], out["cpu"]
    for f in ("q", "q_lat", "snr", "lds"):
        x, y = getattr(a, f).cpu().numpy(), getattr(b, f).numpy()
        assert np.max(np.abs(x - y)) <= 1e-9 * np.max(np.abs(y)), f
