"""The port's copied host modules (config, data, stick-breaking, eval)
give the same outputs as hdpgpc_tpu's, and the port imports no JAX."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

import hdpgpc_torch.config as tcfg
import hdpgpc_torch.data.loader as tload
import hdpgpc_torch.data.priors as tpri
import hdpgpc_torch.ops.stick_breaking as tsb
import hdpgpc_torch.utils.eval as tev
from hdpgpc_tpu import config as jcfg
from hdpgpc_tpu.data import loader as jload
from hdpgpc_tpu.data import priors as jpri
from hdpgpc_tpu.ops import stick_breaking as jsb
from hdpgpc_tpu.utils import eval as jev


def test_port_imports_no_jax():
    code = ("import sys, hdpgpc_torch, hdpgpc_torch.models.hdpgpc, "
            "hdpgpc_torch.convert, hdpgpc_torch.models.stream_online, "
            "hdpgpc_torch.ops.sb_device, hdpgpc_torch.warp.monotone, "
            "hdpgpc_torch.models.ml_em, hdpgpc_torch.models.streaming, "
            "hdpgpc_torch.models.kernel_fit, hdpgpc_torch.ops.kalman; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'hdpgpc_tpu'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("name", ["GPConfig", "HDPConfig", "WarpConfig",
                                  "ModelConfig"])
def test_config_defaults_equal(name):
    a = dataclasses.asdict(getattr(tcfg, name)())
    b = dataclasses.asdict(getattr(jcfg, name)())
    assert a == b
    cfg = tcfg.ModelConfig(compute_dtype="float32")
    assert tcfg.ModelConfig.from_json(cfg.to_json()) == cfg


@pytest.mark.parametrize("L,seed", [(1, 0), (2, 3)])
def test_data_and_priors_equal(L, seed):
    yt, zt = tload.synthetic_beats(50, T=30, n_outputs=L, seed=seed)
    yj, zj = jload.synthetic_beats(50, T=30, n_outputs=L, seed=seed)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(zt, zj)
    np.testing.assert_array_equal(tload.default_x_basis(30),
                                  jload.default_x_basis(30))
    assert tpri.compute_estimators_lds(yt) == jpri.compute_estimators_lds(yj)
    assert tpri.redefine_default_priors(yt, 20) == \
        jpri.redefine_default_priors(yj, 20)


def test_stick_breaking_equal():
    rng = np.random.default_rng(0)
    M = 3
    outs = []
    for sb in (tsb, jsb):
        g = sb.init_globals(M, 1.0, 1.0, 0.1, 0.0)
        resp = np.eye(M + 1)[rng.integers(0, M + 1, 40)] if not outs \
            else outs[0][0]
        rp = resp[:-1, :, None] * resp[1:, None, :]
        rp = np.concatenate([np.zeros((1, M + 1, M + 1)), rp])
        g = sb.reinit_globals(g, M, rp.sum(0), resp[0])
        tt, st = sb.calc_theta_full(g, rp.sum(0), resp[0], M + 1)
        g = sb.HDPGlobals(g.rho, g.omega, tt, st, g.gamma, g.trans_alpha,
                          g.start_alpha, g.kappa)
        g = sb.optimise_globals(g, M=M + 1)
        outs.append((resp, g.rho, g.omega, g.trans_theta,
                     sb.elbo_linears(g, resp, rp),
                     sb.trans_log_pi_from_theta(g.trans_theta, M + 1)))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)


def test_eval_equal():
    class _M:
        T_count = 12

        def member_indexes(self):
            return [np.arange(0, 5), np.arange(5, 12)]

    labels = np.array(list("NNNVN") + list("VVVVNVV"))
    assert tev.classification_error(_M(), labels) == \
        jev.classification_error(_M(), labels)
    a = np.array([0, 0, 1, 1, 2, 2, 2])
    b = np.array([1, 1, 0, 0, 2, 2, 0])
    assert tev.adjusted_rand_index(a, b) == jev.adjusted_rand_index(a, b)
