"""The inducing-point kernel fits of the port (models/kernel_fit.py:
SGPR, SVGP, the scipy fit, the model zoo) and the model's inducing
branch against hdpgpc_tpu, float64 on the CPU.

The bounds at fixed parameters agree to 1e-10 relative, and so do their
gradients. The fits start at a point where some gradients are zero in
exact arithmetic (the lengthscale's, and the inducing locations' with
Z = x): there the first Adam steps, g / (|g| + 1e-8), are decided by
rounding (~1e-16), and each package rounds its own way. So the fits are
held at a capped iteration count, to the agreement that rounding leaves
there: SGPR (200 iterations) to 1e-6 relative in theta and 1e-5 in Z,
SVGP (20 iterations) the same."""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch.models import kernel_fit as tf
from hdpgpc_torch.models.hdpgpc import HDPGPC as TorchHDPGPC
from hdpgpc_tpu.data.loader import default_x_basis, synthetic_beats
from hdpgpc_tpu.data.priors import compute_estimators_lds
from hdpgpc_tpu.models import kernel_fit as jf
from hdpgpc_tpu.models.hdpgpc import HDPGPC as JaxHDPGPC

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T = 24


def _beat():
    y, _ = synthetic_beats(4, T=T, n_clusters=2, noise=0.05, seed=0)
    yb = y[0, :, 0]
    return (np.arange(T, dtype=np.float64), yb,
            (0.01 * np.std(yb) ** 2, np.std(yb) ** 2))


def _params(svgp):
    rng = np.random.default_rng(0)
    x = np.arange(T, dtype=np.float64)
    p = {"raw_s": 0.3, "raw_l": 0.2, "raw_n": -0.1, "c": 0.05,
         "Z": x + 0.1 * rng.standard_normal(T)}
    if svgp:
        p["m_v"] = 0.1 * rng.standard_normal(T)
        p["L_raw"] = np.eye(T) * 0.5 + 0.01 * np.tril(
            rng.standard_normal((T, T)))
    return p


@pytest.mark.parametrize("name", ["_sgpr_nll", "_svgp_nelbo"])
def test_bounds_and_gradients_match_jax(name):
    x, yb, bs = _beat()
    p = _params("svgp" in name)
    keys = list(p)

    def jloss(t):
        return getattr(jf, name)({**t, "n_lb": jnp.asarray(bs[0]),
                                  "n_ub": jnp.asarray(bs[1])},
                                 jnp.asarray(x), jnp.asarray(yb))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    lj, gj = jax.value_and_grad(jloss)(jp)
    tp = {k: torch.tensor(v, dtype=torch.float64).requires_grad_(True)
          for k, v in p.items()}
    lt = getattr(tf, name)(tp, torch.tensor(bs[0]), torch.tensor(bs[1]),
                           torch.tensor(x), torch.tensor(yb))
    gt = torch.autograd.grad(lt, [tp[k] for k in keys])
    assert abs(float(lt.detach()) - float(lj)) <= 1e-10 * abs(float(lj))
    for k, g in zip(keys, gt):
        a, b = g.numpy(), np.asarray(gj[k])
        assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b)), k


@pytest.mark.parametrize("name,iters", [("sgpr", 200), ("svgp", 20)])
def test_inducing_fits_match_jax(name, iters):
    x, yb, bs = _beat()
    thj, Zj = getattr(jf, f"fit_kernel_{name}")(x, yb, bs, max_iters=iters,
                                                 dtype=jnp.float64)
    tht, Zt = getattr(tf, f"fit_kernel_{name}")(x, yb, bs, max_iters=iters,
                                                 dtype=torch.float64,
                                                 device="cpu")
    for a, b in zip(tht, thj):
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), atol=1e-5)
    assert np.all(np.diff(Zt.numpy()) >= 0)
    # the learned lengthscale is not pinned
    assert abs(float(tht.lengthscale) - 1.2) > 1e-3


def test_fit_kernel_scipy_matches_jax():
    x, yb, bs = _beat()
    thj = jf.fit_kernel_scipy(x, yb, bs, n_restarts=1, seed=3)
    tht = tf.fit_kernel_scipy(x, yb, bs, n_restarts=1, seed=3,
                              device="cpu")
    for a, b in zip(tht, thj):
        assert abs(float(a) - float(b)) <= 1e-12 * abs(float(b))


def test_zoo_registry():
    assert set(tf.GP_MODEL_ZOO) == set(jf.GP_MODEL_ZOO)
    x, yb, bs = _beat()
    th = tf.fit_kernel_zoo("ExactGPModel", x, yb, bs, max_iters=5,
                           device="cpu")
    assert isinstance(th, tf.KernelParams)
    th, Z = tf.fit_kernel_zoo("ProjectedGPModel", x, yb, bs, max_iters=5,
                              device="cpu")
    assert Z.shape == (T,)
    for name, msg in (("LinearExactGPModel", "warping_system"),
                      ("AlignmentGPModel", "warping_system"),
                      ("AlignGPModel", "dead code"),
                      ("GPMean", "dead code")):
        with pytest.raises(NotImplementedError, match=msg):
            tf.fit_kernel_zoo(name, x, yb, bs)
    with pytest.raises(KeyError, match="known"):
        tf.fit_kernel_zoo("NoSuchModel")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tf.fit_kernel_sgpr(x, yb, bs, max_iters=1)


def _model(cls, y, **kw):
    std, std_dif, bs, bg = compute_estimators_lds(y)
    dev = {"device": "cpu"} if cls is TorchHDPGPC else {}
    m = cls(default_x_basis(T), n_outputs=1, ini_gamma=std_dif,
            ini_sigma=std, ini_outputscale=10.0, bound_sigma=bs,
            bound_gamma=bg, max_models=100, reestimate_initial_params=True,
            n_explore_steps=3, compute_dtype="float64", **kw, **dev)
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters_inducing=200))
    return m


def test_variational_without_inducing_raises():
    y, _ = synthetic_beats(10, T=T, n_clusters=2, noise=0.03, seed=1)
    m = _model(TorchHDPGPC, y, variational_inducing=True)
    with pytest.raises(ValueError, match="inducing_points=True"):
        m._fit_theta(y[0, :, 0])


@pytest.mark.parametrize("variational", [False, True])
def test_include_batch_inducing_matches_jax(variational):
    """include_batch with inducing_points=True (200-iteration inducing
    fits, the SGPR or SVGP member): partitions equal hdpgpc_tpu's."""
    N = 40
    y, z = synthetic_beats(N, T=T, n_clusters=2, noise=0.03, seed=1)
    x = np.tile(np.arange(T, dtype=np.float64), (N, 1))
    runs = []
    for cls in (JaxHDPGPC, TorchHDPGPC):
        m = _model(cls, y, inducing_points=True,
                   variational_inducing=variational)
        with contextlib.redirect_stdout(io.StringIO()):
            m.include_batch(x, y, with_warp=False, it_limit=2)
        runs.append(m)
    mj, mt = runs
    assert mt.M == mj.M
    assert len(mt.resp_assigned) == len(mj.resp_assigned)
    for a, b in zip(mt.resp_assigned, mj.resp_assigned):
        np.testing.assert_array_equal(a, b)
    assert all(c.fitted for c in mt.clusters[0] if c.members.size)
