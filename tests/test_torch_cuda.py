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

from hdpgpc_torch.ops.kernels import (KernelParams, fused_rbf_gram, gram,
                                      rbf_gram, rbf_gram_noise)
from hdpgpc_torch.ops.spd_solve import (spd_solve, spd_solve_blocked_plain,
                                        spd_solve_plain)

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


@pytest.mark.parametrize("n,T,R", [(16, 90, 90), (64, 90, 90), (4, 90, 90),
                                   (2, 90, 90), (8, 128, 128), (3, 5, 2),
                                   (40, 33, 70), (2, 128, 300),
                                   (4, 200, 200), (2, 300, 7),
                                   (1, 480, 3), (1, 900, 2)])
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
    # no T limit: above what shared memory holds the kernel factors in a
    # scratch buffer that the wrapper allocates
    from hdpgpc_torch.ops import _build
    lib = _build.load()
    assert lib.spd_solve_work_f64(90, 90) == 0
    assert lib.spd_solve_work_f32(192, 192) == 0
    assert lib.spd_solve_work_f64(300, 7) == 320 * 320
    # and where not even one 32-column chunk of the right-hand side fits
    # beside it, the chunk buffers move there too
    assert lib.spd_solve_work_f64(480, 3) == 480 * 480 + 2 * 480 * 32
    with pytest.raises(ValueError):
        spd_solve(a.transpose(1, 2), b)
    with pytest.raises(TypeError):
        spd_solve(a.float(), b)


@pytest.mark.parametrize("n,T,R", [(16, 90, 90), (2, 300, 7)])
def test_spd_solve_kernel_matches_blocked_mirror(cuda, n, T, R):
    """The kernel against its step-by-step mirror in PyTorch, float64:
    the same algorithm, rounded in another order (1e-11 relative)."""
    spd, rhs = _spd(n, T, 7 * T)
    rhs = np.ascontiguousarray(np.resize(rhs, (n, T, R)))
    a = torch.tensor(spd, device=cuda)
    b = torch.tensor(rhs, device=cuda)
    X = spd_solve(a, b)
    Xm = spd_solve_blocked_plain(a, b)
    assert ((X - Xm).abs() / (Xm.abs() + 1e-3)).max().item() < 1e-11


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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gram_noise_fused_in_one_launch(cuda, dtype):
    """gram with the white noise: one launch of kernel A, equal to the
    plain rbf_gram + noise * eye to the last bit."""
    x = torch.arange(90, dtype=dtype, device=cuda)
    p = KernelParams(*[torch.tensor(v, dtype=dtype, device=cuda)
                       for v in (300.0, 1.2, 0.05)])
    before = fused_rbf_gram.launches
    K = gram(p, x)
    torch.cuda.synchronize()
    assert fused_rbf_gram.launches == before + 1
    Kp = rbf_gram_noise(x, x, *p)
    assert torch.equal(K, Kp)
    assert torch.equal(gram(p, x, x), rbf_gram(x, x, p.outputscale,
                                                p.lengthscale))


def test_stream_engine_on_card_matches_cpu(cuda):
    """The float64 engine at chunk 1 on 60 beats of the growth stream
    (three births), card against CPU: equal labels, M and accounting."""
    from hdpgpc_torch.data.loader import (default_x_basis,
                                          synthetic_growth_stream)
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.models.stream_online import OnlineStreamEngine
    from hdpgpc_torch.ops.kernels import fused_rbf_gram
    y, _z = synthetic_growth_stream(120, 24, 4, seed=7, start_beat=0,
                                    interval=15)
    std = float(np.std(y))
    sd = float(np.std(np.diff(y, axis=0)))
    out = {}
    for dev in ("cpu", "cuda"):
        m = HDPGPC(default_x_basis(24), n_outputs=1, ini_gamma=sd,
                   ini_sigma=std, ini_outputscale=4.0,
                   bound_sigma=(std * 0.05, std * 0.2),
                   bound_gamma=(sd * 0.05, sd * 0.2), max_models=8,
                   estimation_limit=50, device=dev)
        eng = OnlineStreamEngine(m, K=8, chunk=1)
        b0, a0 = spd_solve.launches, fused_rbf_gram.launches
        eng.run(y[:60])
        out[dev] = (eng.labels(), int(eng.carry.M),
                    float(eng.carry.q_sel_sum), float(eng.carry.qlat_sel_sum),
                    spd_solve.launches - b0, fused_rbf_gram.launches - a0)
    a, b = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] >= 2
    np.testing.assert_allclose(a[2:4], b[2:4], rtol=1e-8)
    # three kernel B launches a beat on the card (absorb candidates,
    # birth, commit), one kernel A per kernel fit; none on the CPU
    assert a[4] == 3 * 60 and a[5] >= a[1] and b[4] == b[5] == 0


def test_batch_warp_on_card_matches_cpu(cuda):
    """build_batch_warp (B = 64, T = 90, 50 Adam steps, float64, the
    template among the rows) on the card against the CPU: every output
    to 1e-9 relative."""
    from hdpgpc_torch.warp.monotone import build_batch_warp, make_warp_prior
    T, B = 90, 64
    t = np.arange(T) / T
    rng = np.random.default_rng(3)
    shifts = np.r_[0.0, rng.uniform(-0.1, 0.1, B - 1)]
    Y = np.exp(-0.5 * ((t[None] - 0.5 - shifts[:, None]) / 0.08) ** 2)
    Y[1:] += 0.01 * rng.standard_normal((B - 1, T))
    out = {}
    for dev in ("cpu", cuda):
        x = torch.arange(T, dtype=torch.float64, device=dev)
        prior = make_warp_prior(x, 0.05, (1e-6, 1e2))
        r = build_batch_warp(T, train_iter=50)(
            x, torch.tensor(Y, device=dev), torch.tensor(Y[0], device=dev),
            prior, 1.0, 1.0, 0.02)
        out[str(dev)] = [v.cpu().numpy() for v in r]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert np.max(np.abs(a - b)) <= 1e-9 * np.max(np.abs(b))


def test_ml_refit_on_card_matches_cpu(cuda):
    """One ML-EM refit (bayesian_params=False, float64) on the card
    through kernel B against the CPU: scores and parameters to 1e-9
    relative."""
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    T, N = 30, 40
    rng = np.random.default_rng(4)
    Y = np.sin(np.linspace(0, 6, T))[None] + 0.1 * rng.standard_normal(
        (N, T))
    rc = (np.arange(N) % 2 == 0).astype(np.float64)
    out = {}
    for dev in ("cpu", "cuda"):
        m = HDPGPC(np.arange(T, dtype=np.float64), ini_gamma=0.02,
                   ini_sigma=0.1, ini_outputscale=1.5,
                   bound_sigma=(0.005, 0.5), bayesian_params=False,
                   device=dev)
        b0 = spd_solve.launches
        q, ql, _snr, cl = m._full_refit_ml(m.clusters[0][0], 0, Y, rc)
        out[dev] = (q, ql, cl.state.A.cpu().numpy(),
                    cl.state.Sigma.cpu().numpy(), spd_solve.launches - b0)
    a, b = out["cuda"], out["cpu"]
    for x, y in zip(a[:4], b[:4]):
        assert np.max(np.abs(x - y)) <= 1e-9 * np.max(np.abs(y))
    assert a[4] > 0 and b[4] == 0


@pytest.mark.parametrize("R", [256, 2 * 90 + 256, 1929, 2 * 90 + 1929])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-3)])
def test_spd_solve_kernel_at_classifier_shapes(cuda, R, dtype, tol):
    """Kernel B at the frozen-cluster classifier's two calls: K = 64
    systems of T = 90 against a chunk's beats (R = chunk) and against
    [(Q H')', H, the beats] (R = 2T + chunk), chunks of 256 and of 1929
    (what an 80 GB card gives K = 64 in float32)."""
    spd, _ = _spd(64, 90, R)
    rhs = np.random.default_rng(R).standard_normal((64, 90, R)) * 12.0
    a = torch.tensor(spd, dtype=dtype, device=cuda)
    b = torch.tensor(rhs, dtype=dtype, device=cuda)
    X = spd_solve(a, b)
    torch.cuda.synchronize()
    Xp = spd_solve_plain(a, b)
    err = ((X - Xp).abs() / (Xp.abs() + 1e-3)).max().item()
    assert err < tol


def test_stream_classifier_on_card_matches_cpu(cuda):
    """The classifier's chunk step on the card (two kernel-B launches a
    chunk: the scores and the filter elements' shared solve) against the
    CPU in float64: identical labels, states to 1e-9."""
    from hdpgpc_torch.data.loader import synthetic_beats
    from hdpgpc_torch.models import streaming
    y, z = synthetic_beats(600, T=24, n_clusters=3, noise=0.05, seed=2)
    tmpl = np.stack([y[:100][z[:100] == k][:, :, 0].mean(0)
                     for k in range(3)])
    out = {}
    for dev in ("cuda", "cpu"):
        st = streaming.init_stream_state(torch.tensor(tmpl, device=dev),
                                         0.001, 0.05)
        before = spd_solve.launches
        out[dev] = streaming.stream_classify(st, y[100:, :, 0], chunk=128)
        if dev == "cuda":
            assert spd_solve.launches - before == 2 * 4
    (a, la), (b, lb) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(la, lb)
    for f in ("f", "P", "fmsg"):
        x, r = getattr(a, f).cpu(), getattr(b, f)
        assert ((x - r).abs().max() / r.abs().max()).item() < 1e-9
