"""HMM messages, entropy terms and the kernel-hyperparameter Adam fit
of the port against hdpgpc_tpu, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch.models import kernel_fit as tkf
from hdpgpc_torch.ops import hmm as th
from hdpgpc_tpu.models import kernel_fit as jkf
from hdpgpc_tpu.ops import hmm as jh

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)


def _packed(rng, N, K, Kp, dtype=np.float64):
    """A packed FB input as the orchestrator builds it (K padded to Kp
    with -inf columns)."""
    p = np.full((N + Kp + 1, Kp), -np.inf, dtype)
    st = rng.dirichlet(np.ones(K))
    p[0, :K] = np.log(st)
    tr = rng.dirichlet(np.ones(K), size=K)
    p[1:K + 1, :K] = np.log(tr)
    p[Kp + 1:, :K] = -np.abs(rng.standard_normal((N, K))) * 50.0
    return p


@pytest.mark.parametrize("N,K,Kp", [(1, 1, 4), (40, 3, 4), (257, 5, 8)])
def test_fb_hard_packed_matches_jax(N, K, Kp):
    """Hard decisions identical; log messages to 1e-9 absolute (float64
    round-off of log-domain sums over N steps)."""
    p = _packed(np.random.default_rng(N), N, K, Kp)
    rj = jh.fb_hard_packed(jnp.asarray(p))
    rt = th.fb_hard_packed(torch.tensor(p))
    for a, b in ((rt[0], rj[0]), (rt[2], rj[2])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((rt[1], rj[1]), (rt[3], rj[3])):
        a, b = a.numpy(), np.asarray(b)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-9)
    ij = jh.fb_hard_packed_idx(jnp.asarray(p))
    it = th.fb_hard_packed_idx(torch.tensor(p))
    for a, b in zip(it, ij):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_forward_backward_match_sequential_jax():
    rng = np.random.default_rng(1)
    K, N = 4, 33
    sp = np.log(rng.dirichlet(np.ones(K)))
    tp = np.log(rng.dirichlet(np.ones(K), size=K))
    lq = -np.abs(rng.standard_normal((N, K))) * 5.0
    fj, mj = jh.forward_seq(jnp.asarray(sp), jnp.asarray(tp), jnp.asarray(lq))
    ft, mt = th.forward(torch.tensor(sp), torch.tensor(tp), torch.tensor(lq))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-10)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-10)
    bj = jh.backward_seq(jnp.asarray(tp), jnp.asarray(lq))
    bt = th.backward(torch.tensor(tp), torch.tensor(lq))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-10)
    lj = jh.posterior_log_marginals(jnp.log(fj), jnp.log(bj))
    lt = th.posterior_log_marginals(torch.log(ft), torch.log(bt))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_entropy_terms_match_jax(dtype):
    """float64 to 1e-12 relative; float32 to 1e-5 (a sum of N K^2
    float32 terms)."""
    rng = np.random.default_rng(2)
    N, K = 50, 4
    resp = np.eye(K)[rng.integers(0, K, N)].astype(dtype)
    rp = np.zeros((N, K, K), dtype)
    rp[1:] = resp[:-1, :, None] * resp[1:, None, :]
    a = float(th.entropy_terms(torch.tensor(resp), torch.tensor(rp)))
    b = float(jh.entropy_terms(jnp.asarray(resp), jnp.asarray(rp)))
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert abs(a - b) <= tol * max(abs(b), 1.0)


def _beats(B, T, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, T)
    return np.stack([(1 + b) * np.exp(-0.5 * ((t - 0.5) / 0.1) ** 2)
                     + 0.05 * rng.standard_normal(T) for b in range(B)])


@pytest.mark.parametrize("max_iters", [300, 800])
def test_fit_kernel_matches_jax(max_iters):
    """Adam written out in optax's order: the fitted outputscale and
    noise agree to 1e-8 relative in float64 while the fit is still
    descending. (Once the loss is flat to round-off, Adam's normalised
    steps follow the sign of round-off-sized gradients, and two float64
    implementations drift apart by ~1e-4 relative; on this beat that
    happens between steps 800 and 1000.)"""
    T = 24
    y = _beats(1, T, 3)[0]
    x = np.arange(T, dtype=np.float64)
    bounds = (1e-4, 10.0)
    pj = jkf.fit_kernel(x, y, bounds, max_iters=max_iters, dtype=jnp.float64)
    pt = tkf.fit_kernel(x, y, bounds, max_iters=max_iters,
                        dtype=torch.float64, device="cpu")
    for f in ("outputscale", "lengthscale", "noise"):
        a, b = float(getattr(pt, f)), float(getattr(pj, f))
        assert abs(a - b) <= 1e-8 * abs(b), (f, a, b)


def test_fit_kernel_batch_matches_jax_and_solo():
    T = 24
    Ys = _beats(3, T, 4)
    x = np.arange(T, dtype=np.float64)
    bounds = (1e-4, 10.0)
    pj = jkf.fit_kernel_batch(x, Ys, bounds, max_iters=400,
                              dtype=jnp.float64)
    pt = tkf.fit_kernel_batch(x, Ys, bounds, max_iters=400,
                              dtype=torch.float64, device="cpu")
    solo = tkf.fit_kernel(x, Ys[1], bounds, max_iters=400,
                          dtype=torch.float64, device="cpu")
    for a, b in zip(pt, pj):
        for f in ("outputscale", "noise"):
            va, vb = float(getattr(a, f)), float(getattr(b, f))
            assert abs(va - vb) <= 1e-8 * abs(vb)
    assert float(pt[1].outputscale) == pytest.approx(
        float(solo.outputscale), rel=1e-12)
