"""The multi-record scale-out (hdpgpc_torch.parallel.records) against
hdpgpc_tpu's (tests/test_parallel.py:13-94), float64 on the CPU:

* the step against hdpgpc_tpu's build_sharded_vi_step on make_mesh(1),
  R = 4, N = 10, T = 12, K = 2, hdp_update off and on: resp and
  respPair identical, q, q_lat, the ELBO and the states to 1e-9
  relative;
* hdp_update=True against the port's host stick_breaking.calc_theta_full;
* the device theta helpers against hdpgpc_tpu's;
* fb_hard batched over records, bit for bit against one record a call;
* records in groups of 1, 2 and 4, bit for bit against one group;
* a 2-rank gloo group against one process (ELBO to 1e-12), and
  entry.dryrun_multichip(2, device="cpu").

hdpgpc_tpu's step runs in a subprocess with XLA's backend optimisation
off: its jitted hmm.backward is miscompiled on this CPU from about
N = 9 (see tests/test_torch_online.py)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch import convert
from hdpgpc_torch.entry import dryrun_multichip, run_on_ranks
from hdpgpc_torch.ops import hmm as th
from hdpgpc_torch.ops import stick_breaking as tsb
from hdpgpc_torch.parallel import records as tr
from hdpgpc_tpu.parallel import records as jr

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

R, N, T, K = 4, 10, 12, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HDP = dict(trans_alpha=1.0, start_alpha=0.1, kappa=0.0)


def _inputs(seed=0, K=K):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((R, N, T))
    z = rng.integers(0, K, (R, N))
    respPair = np.zeros((R, N, K, K))
    respPair[:, np.arange(1, N)[None, :], z[:, :-1], z[:, 1:]] = 1.0
    return dict(Y=Y, resp=np.eye(K)[z], respPair=respPair,
                rho=np.tile(tsb.create_init_rho(K), (R, 1)),
                start_log_pi=np.log(np.ones((R, K)) / K),
                trans_log_pi=np.log(np.ones((R, K, K)) / K))


# hdpgpc_tpu's step, hdp_update off and on: outputs and the states'
# leaves (jax.tree.leaves order)
_JAX_STEP = """
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {root!r})
from hdpgpc_tpu.parallel.records import (build_sharded_vi_step,
                                         init_record_states, make_mesh)
d = dict(np.load({path!r} + ".in.npz"))
R, N, T = d["Y"].shape
K = d["resp"].shape[2]
out = {{}}
for hdp in (False, True):
    step = build_sharded_vi_step(T, K, make_mesh(1), hdp_update=hdp,
                                 **{hdp_kw!r})
    a4, a5 = ("rho", "respPair") if hdp else ("start_log_pi",
                                              "trans_log_pi")
    res = step(d["Y"], d["resp"], init_record_states(R, K, T), d[a4], d[a5])
    p = "hdp" if hdp else "fixed"
    for name, v in zip(("q", "q_lat", "resp", "respPair", "elbo"), res[:5]):
        out[p + "_" + name] = np.asarray(v)
    for i, leaf in enumerate(jax.tree.leaves(res[5])):
        out[p + f"_st{{i}}"] = np.asarray(leaf)
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """hdpgpc_tpu's two steps, started in their subprocess before the
    module's first test; ``get()`` waits for them."""
    path = str(tmp_path_factory.mktemp("jax_records") / "out.npz")
    np.savez(path + ".in.npz", **_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_STEP.format(root=ROOT, path=path,
                                                hdp_kw=HDP)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    class Handle:
        out = None

        def get(self):
            if self.out is None:
                _so, se = proc.communicate(timeout=300)
                assert proc.returncode == 0, se[-3000:]
                self.out = dict(np.load(path))
            return self.out

    yield Handle()
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _port_states():
    js = jr.init_record_states(R, K, T)
    return convert.record_states_from_numpy(jax.device_get(js))


def _port_step(hdp, d=None, **kw):
    d = _inputs() if d is None else d
    step = tr.build_sharded_vi_step(T, K, hdp_update=hdp, device="cpu",
                                    **HDP, **kw)
    a4, a5 = ("rho", "respPair") if hdp else ("start_log_pi",
                                              "trans_log_pi")
    return step(d["Y"], d["resp"], _port_states(), d[a4], d[a5])


@pytest.mark.parametrize("hdp", [False, True])
def test_step_matches_jax(jax_step, hdp):
    ref = jax_step.get()
    p = "hdp" if hdp else "fixed"
    q, q_lat, resp, respPair, elbo, states = _port_step(hdp)
    np.testing.assert_array_equal(resp.numpy(), ref[p + "_resp"])
    np.testing.assert_array_equal(respPair.numpy(), ref[p + "_respPair"])
    assert _rel(q.numpy(), ref[p + "_q"]) <= 1e-9
    assert _rel(q_lat.numpy(), ref[p + "_q_lat"]) <= 1e-9
    assert _rel(elbo.numpy(), ref[p + "_elbo"]) <= 1e-9
    leaves = convert.tree_leaves(states)
    assert len(leaves) == len([k for k in ref if k.startswith(p + "_st")])
    for i, leaf in enumerate(leaves):
        b = ref[p + f"_st{i}"]
        assert tuple(leaf.shape) == b.shape, i
        assert _rel(leaf.numpy(), b) <= 1e-9, i


def test_state_dtype_follows_the_input():
    """A float32 step computes and returns float32 states from float64
    ones; the member counts stay int32."""
    d = _inputs()
    d["Y"] = d["Y"].astype(np.float32)
    q, *_, states = _port_step(False, d)
    assert q.dtype == torch.float32
    assert states.P_last.dtype == torch.float32
    assert states.n.dtype == torch.int32


def test_hdp_update_matches_host_theta():
    """hdp_update=True recomputes the transition structure on the device
    from counts; record 0 must equal the fixed-pi step fed the host's
    theta (the port's stick_breaking, GPI_HDP.py:400-422, :3527-3535)."""
    d = _inputs(3, K=3)
    Kd = 3
    st = tr.init_record_states(R, Kd, T, device="cpu")
    step = tr.build_sharded_vi_step(T, Kd, hdp_update=True, device="cpu",
                                    **HDP)
    q_s, _, resp_s, _, elbo_s, _ = step(d["Y"], d["resp"], st, d["rho"],
                                        d["respPair"])
    assert np.isfinite(float(elbo_s))
    glob = tsb.init_globals(Kd, 1.0, 1.0, 0.1, 0.0)
    tt, st_theta = tsb.calc_theta_full(glob, d["respPair"][0].sum(axis=0),
                                       d["resp"][0][0], M=Kd + 1)
    trans_lp = tsb.trans_log_pi_from_theta(tt, Kd, log_sum_exp_form=False)
    start_lp = tsb.start_log_pi_from_theta(st_theta, Kd,
                                           log_sum_exp_form=False)
    step1 = tr.build_sharded_vi_step(T, Kd, device="cpu")
    q_1, _, resp_1, _, _, _ = step1(
        d["Y"][:1], d["resp"][:1],
        tr.init_record_states(1, Kd, T, device="cpu"),
        start_lp[None], trans_lp[None])
    np.testing.assert_allclose(q_s[0].numpy(), q_1[0].numpy(), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_array_equal(resp_s[0].numpy(), resp_1[0].numpy())


def test_theta_helpers_match_jax():
    rng = np.random.default_rng(5)
    Kh = 4
    rho = rng.uniform(0.05, 0.95, (3, Kh))
    tc = rng.integers(0, 9, (3, Kh, Kh)).astype(np.float64)
    sc = np.eye(Kh)[rng.integers(0, Kh, 3)]
    kw = dict(trans_alpha=1.3, start_alpha=0.1, kappa=0.7)
    tt, st = tr.theta_from_counts_device(torch.tensor(rho), torch.tensor(tc),
                                         torch.tensor(sc), **kw)
    tl, sl = tr.log_pis_from_theta_device(tt, st, Kh)
    for r in range(3):
        b = jr.rho_to_beta_device(jnp.asarray(rho[r]))
        assert _rel(tr.rho_to_beta_device(torch.tensor(rho[r])).numpy(),
                    b) <= 1e-15
        ttj, stj = jr.theta_from_counts_device(
            jnp.asarray(rho[r]), jnp.asarray(tc[r]), jnp.asarray(sc[r]),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        assert _rel(tt[r].numpy(), ttj) <= 1e-15
        assert _rel(st[r].numpy(), stj) <= 1e-15
        tlj, slj = jr.log_pis_from_theta_device(ttj, stj, Kh)
        assert _rel(tl[r].numpy(), tlj) <= 1e-12
        assert _rel(sl[r].numpy(), slj) <= 1e-12


@pytest.mark.parametrize("Kf,Nf", [(2, 10), (3, 57), (5, 200)])
def test_fb_hard_batched_equals_one_record(Kf, Nf):
    rng = np.random.default_rng(Kf + Nf)
    Rf = 5
    sp = torch.tensor(np.log(rng.dirichlet(np.ones(Kf), size=Rf)))
    tp = torch.tensor(np.log(rng.dirichlet(np.ones(Kf), size=(Rf, Kf))))
    lq = torch.tensor(-np.abs(rng.standard_normal((Rf, Nf, Kf))) * 40.0)
    out = th.fb_hard(sp, tp, lq)
    ent = th.entropy_terms(out[0], out[2])
    for r in range(Rf):
        one = th.fb_hard(sp[r], tp[r], lq[r])
        for a, b in zip(out, one):
            np.testing.assert_array_equal(a[r].numpy(), b.numpy())
        assert torch.equal(ent[r], th.entropy_terms(one[0], one[2]))


@pytest.mark.parametrize("G", [1, 2, 4])
def test_record_groups_are_bit_identical(G):
    one = _port_step(True)
    grouped = _port_step(True, records_per_group=G)
    for a, b in zip(grouped[:5], one[:5]):
        assert torch.equal(a, b)
    for a, b in zip(convert.tree_leaves(grouped[5]),
                    convert.tree_leaves(one[5])):
        assert torch.equal(a, b)


def test_two_rank_gloo_group_matches_one_process():
    d = _inputs()
    out = run_on_ranks(2, d, device="cpu", timeout=120)
    q, q_lat, resp, respPair, elbo, _ = _port_step(False, d)
    assert abs(out["elbo"][0] - float(elbo)) <= 1e-12 * abs(float(elbo))
    assert out["elbo"][0] == out["elbo"][1]
    np.testing.assert_array_equal(out["resp"], resp.numpy())
    np.testing.assert_array_equal(out["respPair"], respPair.numpy())
    assert _rel(out["q"], q.numpy()) <= 1e-12
    assert _rel(out["q_lat"], q_lat.numpy()) <= 1e-12


def test_record_slices_cover_the_records():
    for Rs, W in ((4, 2), (5, 2), (7, 3), (2, 4)):
        idx = np.concatenate([np.arange(Rs)[tr.record_slice(Rs, r, W)]
                              for r in range(W)])
        np.testing.assert_array_equal(idx, np.arange(Rs))
    assert tr.make_mesh() == [0]


def test_dryrun_multichip_cpu():
    out = dryrun_multichip(2, device="cpu")
    assert out["q"].shape == (2, 16, 3)
    assert np.all(np.isfinite(out["elbo"]))
