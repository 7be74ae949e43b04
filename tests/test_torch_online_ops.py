"""The online path's building blocks against hdpgpc_tpu's, float64:

* ops/sb_device.py (masked stick-breaking + elbo_Linears) at Kp in
  {4, 12} and M in {1, 3, Kp - 1}: <= 1e-12 relative;
* the sequential HMM recursions, the incremental forward step and
  Baum-Welch: <= 1e-12;
* gplds.log_sq_error_last / estimate_new / q_lat_tail on JAX states
  carried across with convert.cluster_state_from_numpy: <= 1e-9;
* one stream-engine step from a converted mid-stream carry: the StepOut
  equal and every carry leaf to <= 1e-9."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch import convert
from hdpgpc_torch.data.loader import default_x_basis, synthetic_growth_stream
from hdpgpc_torch.models import gplds as tg
from hdpgpc_torch.models.hdpgpc import HDPGPC as TorchHDPGPC
from hdpgpc_torch.models.stream_online import OnlineStreamEngine as TorchEng
from hdpgpc_torch.ops import hmm as th
from hdpgpc_torch.ops import sb_device as tsb
from hdpgpc_tpu.models import gplds as jg
from hdpgpc_tpu.models.hdpgpc import HDPGPC as JaxHDPGPC
from hdpgpc_tpu.models.stream_online import OnlineStreamEngine as JaxEng
from hdpgpc_tpu.ops import hmm as jh
from hdpgpc_tpu.ops import sb_device as jsb
from hdpgpc_tpu.ops.kernels import KernelParams as JKP

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    f = np.isfinite(b)
    if not f.any():
        return 0.0
    return float(np.max(np.abs(a[f] - b[f]))
                 / max(np.max(np.abs(b[f])), 1e-300))


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _sb_inputs(Kp, M, seed):
    rng = np.random.default_rng(seed)
    rho = np.where(np.arange(Kp) < M, rng.uniform(0.05, 0.9, Kp), 0.0)
    omega = np.where(np.arange(Kp) < M, rng.uniform(1.0, 20.0, Kp), 0.0)
    live = np.arange(Kp + 1) < M
    sc = np.where(live, rng.integers(0, 3, Kp + 1), 0).astype(np.float64)
    tc = rng.integers(0, 9, (Kp + 1, Kp + 1)).astype(np.float64)
    tc = tc * live[:, None] * live[None, :]
    tt = rng.uniform(0.2, 30.0, (Kp + 1, Kp + 1))
    st = rng.uniform(0.2, 30.0, Kp + 1)
    return rho, omega, sc, tc, tt, st


HYP = dict(trans_alpha=1.5, start_alpha=0.7, gamma=2.0)


@pytest.mark.parametrize("kappa", [0.0, 3.0])
@pytest.mark.parametrize("Kp,M", [(4, 1), (4, 3), (12, 1), (12, 3),
                                  (12, 11)])
def test_sb_device_matches_jax(Kp, M, kappa):
    rho, omega, sc, tc, tt, st = _sb_inputs(Kp, M, 10 * Kp + M)
    ta, sa, g = HYP["trans_alpha"], HYP["start_alpha"], HYP["gamma"]
    Mj = jnp.asarray(M, jnp.int32)
    Mt = torch.tensor(M)
    checks = [
        (tsb.create_init_rho_dyn(Kp, Mt), jsb.create_init_rho_dyn(Kp, Mj)),
        (tsb.rho_to_beta_masked(_t(rho), Mt),
         jsb.rho_to_beta_masked(jnp.asarray(rho), Mj)),
        (tsb.c_dir_rows_masked(_t(tt), Mt + 1),
         jsb.c_dir_rows_masked(jnp.asarray(tt), Mj + 1)),
        (tsb.c_dir_vec_masked(_t(st), Mt + 1),
         jsb.c_dir_vec_masked(jnp.asarray(st), Mj + 1)),
        (tsb.l_top_masked(_t(rho), _t(omega), Mt, ta, sa, kappa, g),
         jsb.l_top_masked(jnp.asarray(rho), jnp.asarray(omega), Mj, ta, sa,
                          kappa, g)),
        (tsb.elbo_linear_terms_masked(_t(rho), _t(omega), Mt, Mt, ta, sa,
                                      kappa, g, _t(tt), _t(st), _t(sc),
                                      _t(tc)),
         jsb.elbo_linear_terms_masked(jnp.asarray(rho), jnp.asarray(omega),
                                      Mj, Mj, ta, sa, kappa, g,
                                      jnp.asarray(tt), jnp.asarray(st),
                                      jnp.asarray(sc), jnp.asarray(tc))),
    ]
    tt_t, st_t = tsb.calc_theta_full_masked(_t(rho), Mt, _t(tc), _t(sc),
                                            ta, sa, kappa)
    tt_j, st_j = jsb.calc_theta_full_masked(
        jnp.asarray(rho), Mj, jnp.asarray(tc), jnp.asarray(sc), ta, sa,
        kappa)
    checks += [(tt_t, tt_j), (st_t, st_j)]
    # elbo_Linears with rho live at M (no expansion) and at M - 1 (the
    # expand_globals_tmp padding); M + 1 is the birth candidate's count
    for M_rho in sorted({M, max(M - 1, 1)}):
        for Mc in (M, M + 1):
            checks.append((
                tsb.elbo_linears_online(_t(rho), _t(omega), Mc, M_rho, ta,
                                        sa, kappa, g, _t(sc), _t(tc)),
                jsb.elbo_linears_online(
                    jnp.asarray(rho), jnp.asarray(omega),
                    jnp.asarray(Mc, jnp.int32),
                    jnp.asarray(M_rho, jnp.int32), ta, sa, kappa, g,
                    jnp.asarray(sc), jnp.asarray(tc))))
    for i, (a, b) in enumerate(checks):
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-12, i


def test_sb_device_batched_counts_equal_rows():
    """A leading batch dim on the counts (the engine's K absorb
    candidates in one call) equals one call per row."""
    Kp, M = 12, 5
    rho, omega, sc, tc, _tt, _st = _sb_inputs(Kp, M, 3)
    rng = np.random.default_rng(4)
    tcb = tc[None] + rng.integers(0, 2, (Kp, Kp + 1, Kp + 1)) \
        * (np.arange(Kp + 1) < M)[None, :, None] \
        * (np.arange(Kp + 1) < M)[None, None, :]
    args = (_t(rho), _t(omega), torch.tensor(M), torch.tensor(M - 1), 1.5,
            0.7, 3.0, 2.0, _t(sc))
    batched = tsb.elbo_linears_online(*args, _t(tcb))
    rows = torch.stack([tsb.elbo_linears_online(*args, _t(r)) for r in tcb])
    assert _rel(batched.numpy(), rows.numpy()) <= 1e-14


def _log_q(N, K, seed):
    rng = np.random.default_rng(seed)
    lq = rng.standard_normal((N, K)) * 4.0
    lq[:, -1] = -np.inf                     # an inactive (padding) state
    lq = lq - lq.max(axis=1, keepdims=True)
    tp = np.log(rng.dirichlet(np.ones(K), K))
    sp = np.log(rng.dirichlet(np.ones(K)))
    return sp, tp, lq


@pytest.mark.parametrize("N,K", [(1, 3), (7, 4), (23, 5)])
def test_hmm_sequential_forms_match_jax(N, K):
    sp, tp, lq = _log_q(N, K, N + K)
    fs, ms = th.forward_seq(_t(sp), _t(tp), _t(lq))
    fj, mj = jax.device_get(jh.forward_seq(jnp.asarray(sp), jnp.asarray(tp),
                                           jnp.asarray(lq)))
    assert _rel(fs.numpy(), fj) <= 1e-12 and _rel(ms.numpy(), mj) <= 1e-12
    bs = th.backward_seq(_t(tp), _t(lq))
    bj = jax.device_get(jh.backward_seq(jnp.asarray(tp), jnp.asarray(lq)))
    assert _rel(bs.numpy(), bj) <= 1e-12
    # the scan forms agree with the recursions
    fp, _ = th.forward(_t(sp), _t(tp), _t(lq))
    assert _rel(fp.numpy(), fs.numpy()) <= 1e-12
    assert _rel(th.backward(_t(tp), _t(lq)).numpy(), bs.numpy()) <= 1e-12
    if N > 1:
        fi, mi = th.forward_incremental(fs[-2], _t(tp), _t(lq[-1]))
        fij, mij = jh.forward_incremental(jnp.asarray(fj[-2]),
                                          jnp.asarray(tp),
                                          jnp.asarray(lq[-1]))
        assert _rel(fi.numpy(), np.asarray(fij)) <= 1e-12
        assert _rel(mi.numpy(), np.asarray(mij)) <= 1e-12


@pytest.mark.parametrize("x", [[-3.0, -1.0, -7.5, -np.inf],
                               [0.0, -2.0, -5.0], [0.0, 0.0, -1.0],
                               [-np.inf, -np.inf], [-1e-12, -4.0, -9.0]])
def test_normalize_log_quirk_matches_jax(x):
    np.testing.assert_array_equal(th.normalize_log_quirk(x),
                                  jh.normalize_log_quirk(np.asarray(x)))


@pytest.mark.parametrize("N,K", [(6, 3), (15, 4)])
def test_baum_welch_matches_jax(N, K):
    sp, tp, lq = _log_q(N, K, 7 * N + K)
    sp, tp, lq = sp[:K - 1], tp[:K - 1, :K - 1], lq[:, :K - 1]
    a = jh.forward(jnp.asarray(sp), jnp.asarray(tp), jnp.asarray(lq))[0]
    b = jh.backward(jnp.asarray(tp), jnp.asarray(lq))
    psi = jh.coupled_pair_log(a, b, jnp.asarray(tp), jnp.asarray(lq))
    la, lb, lpsi = (np.asarray(v) for v in (jnp.log(a), jnp.log(b), psi))
    pj, tj = jh.baum_welch(la, lb, lpsi)
    pt, tt = th.baum_welch(_t(la), _t(lb), _t(lpsi))
    assert _rel(pt, np.asarray(pj)) <= 1e-12
    assert _rel(tt, np.asarray(tj)) <= 1e-12


def _jax_states(T):
    """Cluster states with 0, 1, 2 and 9 members (refits of a fresh
    state), the shapes every online primitive branches on."""
    rng = np.random.default_rng(11)
    Y = np.sin(np.linspace(0, 2 * np.pi, T))[None] \
        + 0.1 * rng.standard_normal((20, T))
    th_ = JKP(jnp.asarray(1.5), jnp.asarray(2.0), jnp.asarray(0.05))
    st0 = jg.init_cluster_state(jnp.arange(T, dtype=jnp.float64), th_,
                                0.02, 0.1, 5.0)
    refit = jg.build_refit(T, est_limit=6, pair_smooth=False,
                           full_backward=False)
    out = [st0]
    for n in (1, 2, 9):
        resp = np.zeros(20)
        resp[:n] = 1.0
        out.append(refit(jnp.asarray(Y), jnp.asarray(resp), st0).state)
    return out, Y[-1]


def test_online_primitives_match_jax():
    T = 10
    states, y = _jax_states(T)
    conv = [convert.cluster_state_from_numpy(jax.device_get(s))
            for s in states]
    batched = tg.stack_states(conv)
    yt = _t(y)
    got_b = [tg.log_sq_error_last(batched, yt), tg.estimate_new(batched, yt),
             *tg.q_lat_tail(batched, 0.5)]
    for j, (sj, st) in enumerate(zip(states, conv)):
        want = [jg.log_sq_error_last(sj, jnp.asarray(y)),
                jg.estimate_new(sj, jnp.asarray(y)),
                *jg.q_lat_tail(sj, 0.5)]
        got = [tg.log_sq_error_last(st, yt), tg.estimate_new(st, yt),
               *tg.q_lat_tail(st, 0.5)]
        for k, (a, b, c) in enumerate(zip(got, want, got_b)):
            assert _rel(a.numpy(), np.asarray(b)) <= 1e-9, (j, k)
            # the slot-batched call equals the single one
            assert _rel(c[j].numpy(), a.numpy()) <= 1e-12, (j, k)


T_S, K_S, N_S = 24, 8, 26


def _growth_model(cls, y, **kw):
    std = float(np.std(y))
    sd = float(np.std(np.diff(y, axis=0)))
    return cls(default_x_basis(y.shape[1]), n_outputs=1,
               ini_lengthscale=3.0, bound_lengthscale=(1.0, 20.0),
               ini_gamma=sd, ini_sigma=std, ini_outputscale=4.0,
               bound_sigma=(std * 0.05, std * 0.2),
               bound_gamma=(sd * 0.05, sd * 0.2), verbose=False,
               hmm_switch=True, max_models=K_S, bayesian_params=True,
               estimation_limit=50, free_deg_MNIV=5,
               compute_dtype="float64", **kw)


def test_fast_path_from_converted_caches_matches_jax():
    """hdpgpc_tpu's include_sample_fast streams N_S beats; its clusters
    (convert.cluster_state_from_numpy) and online caches
    (convert.online_caches_from_numpy) start a port model, and both go
    on for 6 beats: equal decisions and caches."""
    from hdpgpc_torch.models.hdpgpc import Cluster
    y, _z = synthetic_growth_stream(120, T_S, 4, seed=7, start_beat=0,
                                    interval=15)
    x = np.arange(T_S, dtype=np.float64)
    mj = _growth_model(JaxHDPGPC, y)
    with contextlib.redirect_stdout(io.StringIO()):
        for i in range(N_S):
            mj.include_sample_fast(x, y[i], with_warp=False)
    assert mj.M == 2
    mt = _growth_model(TorchHDPGPC, y, device="cpu")
    for k, v in convert.online_caches_from_numpy(mj).items():
        setattr(mt, k, v)
    mt.M = mj.M
    mt.snr_norm = np.array(mj.snr_norm)
    mt._y_all = np.array(mj._y_all)
    mt.clusters = [[Cluster(convert.cluster_state_from_numpy(
        jax.device_get(c.state)), c.fitted, c.members) for c in row]
        for row in mj.clusters]
    with contextlib.redirect_stdout(io.StringIO()):
        for i in range(N_S, N_S + 6):
            assert mt.include_sample_fast(x, y[i], with_warp=False) \
                == mj.include_sample_fast(x, y[i], with_warp=False)
    assert mt.M == mj.M and mt.T_count == mj.T_count == N_S + 6
    np.testing.assert_array_equal(mt.resp_assigned[-1],
                                  mj.resp_assigned[-1])
    for f in ("q_last", "q_lat_last", "resp_last", "respPair_last"):
        assert _rel(getattr(mt, f), getattr(mj, f)) <= 1e-9, f


def test_engine_step_from_converted_carry_matches_jax():
    """hdpgpc_tpu's engine streams N_S beats (one birth among them);
    its carry, converted, goes through one step of the port's engine
    and of the reference's on the next beat."""
    y, _z = synthetic_growth_stream(120, T_S, 4, seed=7, start_beat=0,
                                    interval=15)
    je = JaxEng(_growth_model(JaxHDPGPC, y), K=K_S, chunk=1)
    with contextlib.redirect_stdout(io.StringIO()):
        je.run(y[:N_S])
    assert int(je.carry.M) == 2
    te = TorchEng(_growth_model(TorchHDPGPC, y, device="cpu"), K=K_S,
                  chunk=1)
    te._build()
    carry_t = convert.stream_state_from_numpy(jax.device_get(je.carry))

    def leaves(tree_t):
        return jax.tree.leaves(tg.tree_map(lambda v: v.numpy(), tree_t))

    # the converted carry is the JAX carry, leaf for leaf
    for a, b in zip(leaves(carry_t), jax.tree.leaves(
            jax.device_get(je.carry)), strict=True):
        np.testing.assert_array_equal(a, b)
    new_t, out_t = te.step(carry_t, _t(y[N_S]))
    new_j, out_j = jax.device_get(je._chunk_fn(
        je.carry, jnp.asarray(y[N_S:N_S + 1])))
    for f in out_t._fields:
        assert int(getattr(out_t, f)) == int(getattr(out_j, f)[0]), f
    for i, (a, b) in enumerate(zip(leaves(new_t), jax.tree.leaves(new_j),
                                   strict=True)):
        assert _rel(a, b) <= 1e-9, i
