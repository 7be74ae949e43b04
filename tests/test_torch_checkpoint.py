"""Checkpoints: hdpgpc_tpu's npz format 2, written and read by both
packages. A model reloaded from labels (T = 24, K = 3, 2 leads) is
saved by one package and loaded by the other (or by itself): the
loaded model must hold the writer's state leaves unchanged and label
new beats as the writer does (cluster_new_batch without learning), in
float32 and float64."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from hdpgpc_torch import convert
from hdpgpc_torch.models.hdpgpc import HDPGPC as TorchHDPGPC
from hdpgpc_tpu.data.loader import default_x_basis, synthetic_beats
from hdpgpc_tpu.data.priors import compute_estimators_lds
from hdpgpc_tpu.models.hdpgpc import HDPGPC as JaxHDPGPC

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T, N_TRAIN, N_NEW, K, L = 24, 60, 20, 3, 2


def _leaves(m):
    """Every cluster state's leaves as numpy, in checkpoint order."""
    if isinstance(m, TorchHDPGPC):
        return [[leaf.cpu().numpy() for leaf in convert.tree_leaves(c.state)]
                for row in m.clusters for c in row]
    import jax
    return [[np.asarray(leaf) for leaf in jax.tree.leaves(c.state)]
            for row in m.clusters for c in row]


@pytest.fixture(scope="module", params=["float64", "float32"])
def trained(request, tmp_path_factory):
    """Both packages' models reloaded from the same labels, saved."""
    dtype = request.param
    y, z = synthetic_beats(N_TRAIN + N_NEW, T=T, n_clusters=K, n_outputs=L,
                           noise=0.03, seed=0)
    std, std_dif, bs, bg = compute_estimators_lds(y[:N_TRAIN])
    x = np.tile(np.arange(T, dtype=np.float64), (N_TRAIN, 1))
    models, paths = {}, {}
    d = tmp_path_factory.mktemp(dtype)
    for name, cls, kw in (("jax", JaxHDPGPC, {}),
                          ("torch", TorchHDPGPC, {"device": "cpu"})):
        m = cls(default_x_basis(T), n_outputs=L, ini_gamma=std_dif,
                ini_sigma=std, ini_outputscale=10.0, bound_sigma=bs,
                bound_gamma=bg, max_models=100,
                reestimate_initial_params=False, n_explore_steps=3,
                compute_dtype=dtype, **kw)
        m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
            m.cfg.gp, kernel_fit_iters=300, kernel_fit_iters_f32=300))
        with contextlib.redirect_stdout(io.StringIO()):
            m.reload_model_from_labels(x, y[:N_TRAIN], z[:N_TRAIN], M=K)
        paths[name] = str(d / f"{name}.npz")
        m.save_swgp(paths[name])
        models[name] = m
    return models, paths, y[N_TRAIN:], x[:N_NEW]


def _labels(m, y_new, x_new):
    with contextlib.redirect_stdout(io.StringIO()):
        return m.cluster_new_batch(x_new, y_new)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_checkpoint_interchange(trained, writer, reader):
    models, paths, y_new, x_new = trained
    src = models[writer]
    if reader == "torch":
        loaded = TorchHDPGPC.load_swgp(paths[writer], device="cpu")
    else:
        loaded = JaxHDPGPC.load_swgp(paths[writer])
    for a, b in zip(_leaves(loaded), _leaves(src)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    assert loaded.M == src.M and loaded.T_count == src.T_count
    np.testing.assert_array_equal(loaded.f_ind_old, src.f_ind_old)
    np.testing.assert_array_equal(loaded.glob.trans_theta,
                                  src.glob.trans_theta)
    assert loaded.train_elbo == [float(e) for e in src.train_elbo]
    for ca, cb in zip(loaded.clusters[0], src.clusters[0]):
        np.testing.assert_array_equal(ca.members, cb.members)
        assert bool(ca.fitted) == bool(cb.fitted)
    ref = _labels(src, y_new, x_new)
    np.testing.assert_array_equal(_labels(loaded, y_new, x_new), ref)
    # and both writers' models label alike
    np.testing.assert_array_equal(_labels(models["jax"], y_new, x_new), ref)


def test_checkpoint_keys_and_meta_match(trained):
    """The two writers' archives hold the same keys with the same dtypes
    and shapes, and the same metadata apart from the ELBO's last digits
    (float32 rounding)."""
    _models, paths, _y, _x = trained
    with np.load(paths["jax"]) as zj, np.load(paths["torch"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            if k == "__meta__":
                continue
            assert (zj[k].dtype, zj[k].shape) == (zt[k].dtype, zt[k].shape), k
        mj = json.loads(bytes(zj["__meta__"]).decode())
        mt = json.loads(bytes(zt["__meta__"]).decode())
    assert mj["format"] == mt["format"] == 2
    for k in ("cfg", "M", "T_count", "fitted", "y_scale"):
        assert mj[k] == mt[k], k
    np.testing.assert_allclose(mt["train_elbo"], mj["train_elbo"],
                               rtol=1e-5)


def test_load_refuses_non_zip_and_defaults_to_the_card(tmp_path):
    p = tmp_path / "legacy.pkl"
    p.write_bytes(b"\x80\x04not a zip archive")
    with pytest.raises(ValueError, match="legacy"):
        TorchHDPGPC.load_swgp(str(p), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TorchHDPGPC.load_swgp(str(p))
