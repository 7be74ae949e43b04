"""Per-cluster GP-LDS emission model: the batched cluster refit
(counterpart of hdpgpc_tpu.models.gplds).

One refit runs, for each of J jobs (cluster, lead) at once:

    forward loop (Kalman step + tail-pair RTS smoothing + 1-step MNIW
                  conjugate update per member)
    -> reverse loop (full RTS smoother)
    -> emission scoring (compute_sq_err_all parity)
    -> latent scoring  (compute_q_lat_all parity)

The JAX reference vmaps one job's program over jobs; here the job
dimension is written out as the leading dimension of every tensor, and
a per-job branch ``jnp.where(first, ...)`` becomes ``torch.where`` on a
(J, 1, 1) mask. The reference's ``lax.scan`` loops are Python loops
over the member slots; its associative scans use ``ops.scan``.

The online single-sample primitives (``log_sq_error_last``,
``estimate_new``, ``q_lat_tail``) and the GP observation APIs
(``observe``, ``observe_latent``, ``sample_observations``,
``kl_divergence``) sit at the end of the module.

Every step's SPD systems {S_innov, P_pred, V_int, V_obs} are solved by
ONE call, ``ops.spd_solve.spd_solve`` on (4 J, T, T): kernel B on the
card. The other Choleskys (MNIW mean, the frozen tail, the scoring)
stay ``torch.linalg`` as they were XLA in the reference.

Reference semantics preserved (see hdpgpc_tpu.models.gplds):

* scores omit the log-determinant (GPI_model.py:92-113, :250-286);
* members score against their own post-inclusion filtered state;
  non-members against the state before the preceding member's
  inclusion (GPI_model.py:494-533);
* the first member's score covariance is inflated by
  1e-2 * mean(diag(Sigma0)) (GPI_model.py:272, :528-529);
* 1-step MNIW updates zero the state covariances and anneal scales by
  +Gamma0/N^2, +Sigma0/N^2 (GPI_model.py:996-998, :1083-1091);
* parameters freeze once N >= estimation_limit (GPI_model.py:974,1092);
* ``pair_smooth`` selects the offline (pair-smoothed) MNIW regressor.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from hdpgpc_torch.models import mniw as mniw_ops
from hdpgpc_torch.models.mniw import MNIW
from hdpgpc_torch.ops import linalg
from hdpgpc_torch.ops.kalman import LDSParams, kalman_step, rts_pair
from hdpgpc_torch.ops.kernels import KernelParams, gram
from hdpgpc_torch.ops.scan import associative_scan
from hdpgpc_torch.ops.spd_solve import spd_solve

LOG2PI = linalg.LOG2PI


class ClusterState(NamedTuple):
    """Compact per-(cluster, lead) state summary (all fixed shapes).
    Inside a batched refit every field carries a leading job dim."""

    theta: KernelParams             # fitted kernel hyperparameters
    K0: torch.Tensor                # (T, T) kernel gram on the basis
    A_def: torch.Tensor             # (T, T) default LDS params
    Gamma_def: torch.Tensor
    C_def: torch.Tensor
    Sigma_def: torch.Tensor
    n: torch.Tensor                 # int32 member count
    f_last: torch.Tensor            # (T, 1) filtered mean, last member
    P_last: torch.Tensor            # (T, T)
    f_prev: torch.Tensor            # filtered, second-to-last member
    P_prev: torch.Tensor
    f_sm_last: torch.Tensor         # smoothed: last three members + first
    P_sm_last: torch.Tensor
    f_sm_prev: torch.Tensor
    P_sm_prev: torch.Tensor
    f_sm_prev2: torch.Tensor
    P_sm_prev2: torch.Tensor
    f_sm_first: torch.Tensor
    P_sm_first: torch.Tensor
    A: torch.Tensor                 # (T, T) current LDS params
    Gamma: torch.Tensor
    C: torch.Tensor
    Sigma: torch.Tensor
    A_prev: torch.Tensor            # params after the second-to-last member
    Gamma_prev: torch.Tensor
    mniw_int: MNIW                  # internal (A, Gamma) posterior
    mniw_obs: MNIW                  # observation (C, Sigma) posterior


def tree_map(fn, *trees):
    """Map ``fn`` over the tensors of NamedTuple trees."""
    t0 = trees[0]
    if isinstance(t0, tuple):
        return type(t0)(*[tree_map(fn, *xs) for xs in zip(*trees)])
    return fn(*trees)


def stack_states(states):
    """Stack unbatched states along a new leading job dim."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


def index_state(st, j: int):
    return tree_map(lambda x: x[j], st)


def _t(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def _eye(T: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(T, dtype=like.dtype, device=like.device)


def _w(cond: torch.Tensor, a, b):
    """torch.where with ``cond`` broadcast from the leading dims."""
    c = cond.reshape(tuple(cond.shape) + (1,) * (a.ndim - cond.ndim))
    return torch.where(c, a, b)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-job gather along dim 1: x (J, S, ...), idx (J, K) ->
    (J, K, ...)."""
    jr = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[jr, idx]


def _take1(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-job pick along dim 1: x (J, S, ...), idx (J,) -> (J, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _dmean(M: torch.Tensor, floor: float) -> torch.Tensor:
    return torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1).abs().mean(-1),
                       min=floor)


def _slots_scan(fn, elems, reverse=False):
    """associative_scan over the slot axis (dim 1) of job-first tensors."""
    out = associative_scan(fn, tuple(e.transpose(0, 1) for e in elems),
                           reverse=reverse)
    return tuple(o.transpose(0, 1) for o in out)


def init_cluster_state(x_basis: torch.Tensor, theta: KernelParams,
                       ini_gamma, ini_sigma, free_deg: float,
                       dtype=torch.float64) -> ClusterState:
    """Fresh cluster with GPR_dynamic initial conditions
    (GPI_model.py:191-205, :115-175); on x_basis's device."""
    dev = x_basis.device
    T = x_basis.shape[0]
    eye = torch.eye(T, dtype=dtype, device=dev)
    theta = KernelParams(*[torch.as_tensor(v, dtype=dtype, device=dev)
                           for v in theta])
    xb = x_basis.reshape(-1).to(dtype)
    K0 = gram(theta, xb, xb, include_noise=False)
    A0, C0 = eye, eye
    G0 = float(ini_gamma) * eye
    S0 = float(ini_sigma) * eye
    z = torch.zeros((T, 1), dtype=dtype, device=dev)
    return ClusterState(
        theta=theta, K0=K0, A_def=A0, Gamma_def=G0, C_def=C0, Sigma_def=S0,
        n=torch.zeros((), dtype=torch.int32, device=dev),
        f_last=z, P_last=K0, f_prev=z, P_prev=K0,
        f_sm_last=z, P_sm_last=K0, f_sm_prev=z, P_sm_prev=K0,
        f_sm_prev2=z, P_sm_prev2=K0, f_sm_first=z, P_sm_first=K0,
        A=A0, Gamma=G0, C=C0, Sigma=S0, A_prev=A0, Gamma_prev=G0,
        mniw_int=mniw_ops.make_mniw(A0, free_deg, G0),
        mniw_obs=mniw_ops.make_mniw(C0, free_deg, S0),
    )


def reinit_cluster_state(st: ClusterState, free_deg: float) -> ClusterState:
    """reinit_GP + reinit_LDS(save_last=False): reset the dynamics to
    the (post-kernel-fit) defaults, keep the fitted kernel
    (GPI_model.py:408-457)."""
    z = torch.zeros_like(st.f_last)
    eye = _eye(st.A_def.shape[-1], st.A_def).expand_as(st.A_def)
    n0 = torch.full(st.n.shape, float(free_deg), dtype=torch.float64,
                    device=st.n.device)
    return st._replace(
        n=torch.zeros_like(st.n),
        f_last=z, P_last=st.K0, f_prev=z, P_prev=st.K0,
        f_sm_last=z, P_sm_last=st.K0, f_sm_prev=z, P_sm_prev=st.K0,
        f_sm_prev2=z, P_sm_prev2=st.K0, f_sm_first=z, P_sm_first=st.K0,
        A=st.A_def, Gamma=st.Gamma_def, C=st.C_def, Sigma=st.Sigma_def,
        A_prev=st.A_def, Gamma_prev=st.Gamma_def,
        mniw_int=MNIW(st.A_def, eye, n0, st.Gamma_def),
        mniw_obs=MNIW(st.C_def, eye, n0, st.Sigma_def),
    )


def apply_kernel_fit(st: ClusterState, x_basis: torch.Tensor,
                     theta: KernelParams) -> ClusterState:
    """Post-kernel-fit state rewrite (GPI_model.fit_kernel_params,
    GPI_model.py:207-241): Sigma <- ini_sigma*I (the reference discards
    the fitted noise here, :215-216), Gamma <- mean(diag(Gamma))*I,
    A = C = I, zero mean, cov = new gram; MNIW anchors re-set."""
    T = st.A.shape[-1]
    dtype, dev = st.A.dtype, st.A.device
    eye = torch.eye(T, dtype=dtype, device=dev)
    theta = KernelParams(*[torch.as_tensor(v, dtype=dtype, device=dev)
                           for v in theta])
    xb = torch.as_tensor(x_basis, device=dev).reshape(-1).to(dtype)
    K0 = gram(theta, xb, xb, include_noise=False)
    S = st.Sigma[..., 0, 0][..., None, None] * eye
    G = torch.diagonal(st.Gamma, dim1=-2, dim2=-1).mean(-1)[..., None,
                                                            None] * eye
    z = torch.zeros((T, 1), dtype=dtype, device=dev)
    return st._replace(
        theta=theta, K0=K0,
        Sigma_def=S, A=eye, C=eye, Gamma=G, Sigma=S, A_prev=eye,
        Gamma_prev=G,
        f_last=z, P_last=K0, f_prev=z, P_prev=K0,
        f_sm_last=z, P_sm_last=K0, f_sm_prev=z, P_sm_prev=K0,
        f_sm_prev2=z, P_sm_prev2=K0, f_sm_first=z, P_sm_first=K0,
        mniw_int=st.mniw_int._replace(mean=eye, scale=G),
        mniw_obs=st.mniw_obs._replace(mean=eye, scale=S),
    )


def _rel_jit(M: torch.Tensor, scale: float) -> torch.Tensor:
    """Relative diagonal jitter (batched): scale * mean|diag|."""
    d = _dmean(M, torch.finfo(M.dtype).eps)
    return M + scale * d[..., None, None] * _eye(M.shape[-1], M)


def _tail_filter(Y_t, member_t, f_H, P_H, A, G, C, S):
    """Fixed-parameter parallel Kalman filter over the frozen tail
    (Sarkka & Garcia-Fernandez 2021); job-first: Y_t (J, Bt, T),
    member_t (J, Bt) bool, head-end state f_H (J, T, 1), P_H (J, T, T).
    Returns filtered means (J, Bt, T, 1) and covariances (J, Bt, T, T);
    padding slots carry the last member's state forward."""
    J, Bt, T = Y_t.shape
    dtype = Y_t.dtype
    eye = _eye(T, Y_t)
    zT = torch.zeros((T, T), dtype=dtype, device=Y_t.device)
    f32 = dtype == torch.float32
    jit = (lambda M: _rel_jit(M, 1e-5)) if f32 else (lambda M: M)

    CGC = C @ G @ _t(C) + S
    S_in = jit(0.5 * (CGC + _t(CGC)))
    L_S = linalg.chol(S_in)
    K = _t(linalg.cho_solve(L_S, _t(G @ _t(C))))          # G C' S^-1
    IKH = eye - K @ C
    A_e = IKH @ A
    C_e = IKH @ G
    Sinv_H = linalg.cho_solve(L_S, C)                      # S^-1 C
    J_sh = _t(A) @ _t(C) @ Sinv_H @ A
    Vs = _t(Sinv_H @ A)                                    # A'C'S^-1
    b_all = Y_t @ _t(K)                                    # (J, Bt, T)
    eta_all = Y_t @ _t(Vs)

    m0 = A @ f_H
    P0 = A @ P_H @ _t(A) + G
    CPC = C @ P0 @ _t(C) + S
    S0 = jit(0.5 * (CPC + _t(CPC)))
    L0 = linalg.chol(S0)
    K0 = _t(linalg.cho_solve(L0, _t(P0 @ _t(C))))
    b0 = m0 + K0 @ (Y_t[:, 0][..., None] - C @ m0)
    C0 = P0 - K0 @ S0 @ _t(K0)

    mem = member_t[..., None, None]
    m_0 = member_t[:, 0]
    z_T1 = torch.zeros((T, 1), dtype=dtype, device=Y_t.device)
    A_el = torch.where(mem, A_e[:, None], eye)
    A_el[:, 0] = _w(m_0, zT.expand(J, T, T), eye.expand(J, T, T))
    b_el = torch.where(mem, b_all[..., None], z_T1)
    b_el[:, 0] = _w(m_0, b0, z_T1.expand(J, T, 1))
    C_el = torch.where(mem, C_e[:, None], zT)
    C_el[:, 0] = _w(m_0, C0, zT.expand(J, T, T))
    eta_el = torch.where(mem, eta_all[..., None], z_T1)
    eta_el[:, 0] = z_T1
    J_el = torch.where(mem, J_sh[:, None], zT)
    J_el[:, 0] = zT

    def combine(el, er):
        A1, b1, C1, eta1, J1 = el
        A2, b2, C2, eta2, J2 = er
        I_C1J2 = eye + C1 @ J2
        I_J2C1 = eye + J2 @ C1
        M = _t(torch.linalg.solve(_t(I_C1J2), _t(A2)))
        Nt = torch.linalg.solve(_t(I_J2C1), A1)
        return (M @ A1,
                M @ (b1 + C1 @ eta2) + b2,
                M @ C1 @ _t(A2) + C2,
                _t(Nt) @ (eta2 - J2 @ b1) + eta1,
                _t(Nt) @ J2 @ A1 + J1)

    _, b, Cc, _, _ = _slots_scan(combine, (A_el, b_el, C_el, eta_el, J_el))
    return b, 0.5 * (Cc + _t(Cc))


def _tail_steady(Y_t, member_t, f_H, P_H, A, G, C, S, anchor,
                 warm: int = 64):
    """float32 speed-mode tail: exact warm-up steps, then the converged
    (LTI) gain as a matmul-only associative scan; the smoothed
    covariance is a distance-to-anchor table and the warm-up region is
    re-smoothed exactly. Job-first shapes as in ``_tail_filter``.
    Returns (f_filt, P_filt, f_sm, P_sm) for the Bt tail slots."""
    J, Bt, T = Y_t.shape
    dtype = Y_t.dtype
    eye = _eye(T, Y_t)
    W = min(warm, Bt)

    def jit32(M):
        return _rel_jit(0.5 * (M + _t(M)), 1e-5)

    f, P = f_H, P_H
    f_warm, P_warm = [], []
    for s in range(W):
        y, mflag = Y_t[:, s], member_t[:, s]
        m = A @ f
        P_pred = A @ P @ _t(A) + G
        S_in = jit32(C @ P_pred @ _t(C) + S)
        L = linalg.chol(S_in)
        K = _t(linalg.cho_solve(L, _t(P_pred @ _t(C))))
        f_up = m + K @ (y[..., None] - C @ m)
        IKC = eye - K @ C
        P_up = IKC @ P_pred @ _t(IKC) + K @ S @ _t(K)
        f = _w(mflag, f_up, f)
        P = _w(mflag, P_up, P)
        f_warm.append(f)
        P_warm.append(P)
    f_W, P_W = f, P
    f_warm = torch.stack(f_warm, 1)
    P_warm = torch.stack(P_warm, 1)

    P_pred_ss = A @ P_W @ _t(A) + G
    S_ss = jit32(C @ P_pred_ss @ _t(C) + S)
    L_ss = linalg.chol(S_ss)
    K_ss = _t(linalg.cho_solve(L_ss, _t(P_pred_ss @ _t(C))))
    IKC = eye - K_ss @ C
    P_ss = IKC @ P_pred_ss @ _t(IKC) + K_ss @ S @ _t(K_ss)
    M_mem = IKC @ A

    Br = Bt - W
    if Br > 0:
        memr = member_t[:, W:]
        Ms = torch.where(memr[..., None, None], M_mem[:, None], eye)
        bs = torch.where(memr[..., None], Y_t[:, W:] @ _t(K_ss),
                         torch.zeros((), dtype=dtype,
                                     device=Y_t.device))[..., None]
        Mc, bc = _slots_scan(
            lambda l, r: (r[0] @ l[0], r[0] @ l[1] + r[1]), (Ms, bs))
        f_rest = Mc @ f_W[:, None] + bc
        f_filt = torch.cat([f_warm, f_rest], 1)
        P_filt = torch.cat([P_warm, P_ss[:, None].expand(J, Br, T, T)], 1)
    else:
        f_filt, P_filt = f_warm, P_warm

    P_pred2 = jit32(A @ P_ss @ _t(A) + G)
    L2 = linalg.chol(P_pred2)
    E = _t(linalg.cho_solve(L2, _t(P_ss @ _t(A))))
    anc = anchor[..., None, None]
    Ems = torch.where(anc, torch.zeros((), dtype=dtype, device=Y_t.device),
                      E[:, None])
    vs = torch.where(anc, f_filt, f_filt - E[:, None] @ (A[:, None] @ f_filt))
    _, f_sm = _slots_scan(
        lambda a, b: (b[0] @ a[0], b[0] @ a[1] + b[1]), (Ems, vs),
        reverse=True)

    W2 = 48
    table = [P_ss]
    P_d = P_ss
    for _ in range(W2 - 1):
        P_d = P_ss + E @ (P_d - P_pred2) @ _t(E)
        table.append(P_d)
    table = torch.stack(table, 1)                       # (J, W2, T, T)
    anchor_pos = torch.argmax(anchor.to(torch.int8), dim=1)
    d = torch.clamp(anchor_pos[:, None]
                    - torch.arange(Bt, device=Y_t.device), 0, W2 - 1)
    P_sm = _take(table, d)

    started0 = torch.logical_not(torch.any(anchor[:, :W], dim=1))
    f_after = f_sm[:, W] if W < Bt else f_W
    P_after = P_sm[:, W] if W < Bt else P_W
    f_next = _w(started0, f_after, f_W)
    P_next = _w(started0, P_after, P_W)
    started = started0
    f_sm_w, P_sm_w = [None] * W, [None] * W
    for s in range(W - 1, -1, -1):
        mflag, f_t, P_t = member_t[:, s], f_warm[:, s], P_warm[:, s]
        f_smp, P_smp = rts_pair(f_t, P_t, f_next, P_next, A, G)
        f_s = _w(started, f_smp, f_t)
        P_s = _w(started, P_smp, P_t)
        f_next = _w(mflag, f_s, f_next)
        P_next = _w(mflag, P_s, P_next)
        started = started | mflag
        f_sm_w[s], P_sm_w[s] = f_s, P_s
    f_sm = torch.cat([torch.stack(f_sm_w, 1), f_sm[:, W:]], 1)
    P_sm = torch.cat([torch.stack(P_sm_w, 1), P_sm[:, W:]], 1)
    return f_filt, P_filt, f_sm, P_sm


def _tail_smooth(f_filt_t, P_filt_t, A, G, anchor):
    """Fixed-parameter parallel RTS smoother over the frozen tail.
    ``anchor`` (J, Bt) bool: True at the LAST member slot and every
    padding slot after it (E=0, g=f, L=P cut the recursion there)."""
    f32 = f_filt_t.dtype == torch.float32
    A_ = A[:, None]
    P_pred = A_ @ P_filt_t @ _t(A_) + G[:, None]
    P_sym = 0.5 * (P_pred + _t(P_pred))
    P_sym = _rel_jit(P_sym, 1e-5 if f32 else 1e-12)
    L = linalg.chol(P_sym)
    E = _t(linalg.cho_solve(L, _t(P_filt_t @ _t(A_))))
    g = f_filt_t - E @ (A_ @ f_filt_t)
    Lm = P_filt_t - E @ P_pred @ _t(E)
    anc = anchor[..., None, None]
    E = torch.where(anc, torch.zeros_like(E), E)
    g = torch.where(anc, f_filt_t, g)
    Lm = torch.where(anc, P_filt_t, Lm)

    def combine_rev(a, b):
        E_a, g_a, L_a = a
        E_b, g_b, L_b = b
        return (E_b @ E_a, E_b @ g_a + g_b, E_b @ L_a @ _t(E_b) + L_b)

    _, gs, Ls = _slots_scan(combine_rev, (E, g, Lm), reverse=True)
    return gs, 0.5 * (Ls + _t(Ls))


def make_forward_step(T, limit, annealing, dynamic, update_params,
                      pair_smooth, full_backward):
    """One member-append step of the refit loop (Kalman update +
    tail-pair smoothing + 1-step MNIW update), batched over jobs.

    ``carry`` = (f, P, f_prevF, P_prevF, A, G, C, S, mniw2, n, noise0,
    G0diag, S0diag), each with a leading job dim J; mniw2 holds the
    internal/observation posteriors stacked on dim 1. ``inp`` =
    (y (J, T), h (J,) in {0, 1})."""

    def forward_step(carry, inp):
        (f, P, f_prevF, P_prevF, A, G, C, S, mniw, n,
         noise0, G0diag, S0diag) = carry
        y, h = inp
        dtype = f.dtype
        Jn = f.shape[0]
        eye = _eye(T, f)
        member = h > 0.99
        first = n == 0
        N_new = n + 1
        N_newf = N_new.to(dtype)

        # Kalman update + tail-pair smoothing sharing the predicted
        # covariance; all SPD systems of the step in one solve
        m = A @ f
        P_pred_dyn = A @ P @ _t(A) + G
        P_pred_kal = _w(first, P, P_pred_dyn)
        y_pred = _w(first, torch.zeros_like(m), C @ m)
        R = _w(first, noise0[:, None, None] * eye, S)
        S_innov = C @ P_pred_kal @ _t(C) + R
        stacked = torch.stack([0.5 * (S_innov + _t(S_innov)),
                               0.5 * (P_pred_dyn + _t(P_pred_dyn))], 1)
        if dtype == torch.float32:
            # float32 speed mode: relative jitter on near-singular inputs
            stacked = stacked + (1e-5 * _dmean(stacked, 1e-30))[
                ..., None, None] * eye
        rhs_list = [C @ P_pred_kal, A @ P]
        if update_params and dynamic:
            # the MNIW row-covariance inversions ride the same solve
            # (V_int/V_obs are carry state)
            Vm = mniw.row_cov                                  # (J, 2, T, T)
            jit2 = 1e-2 * _dmean(mniw.scale, torch.finfo(dtype).eps)
            if dtype == torch.float32:
                jit2 = jit2 + 1e-5 * _dmean(Vm, 1e-30)
            V_sym = 0.5 * (Vm + _t(Vm)) + jit2[..., None, None] * eye
            stacked = torch.cat([stacked, V_sym], 1)
            rhs_list += [eye.expand(Jn, T, T), eye.expand(Jn, T, T)]
        rhs = torch.stack(rhs_list, 1)
        k = rhs.shape[1]
        X = spd_solve(stacked.reshape(Jn * k, T, T).contiguous(),
                      rhs.reshape(Jn * k, T, T).contiguous()
                      ).reshape(Jn, k, T, T)
        K = _t(X[:, 0])                                   # P_pred C' S^-1
        f_up = m + K @ (y[..., None] - y_pred)
        IKC = eye - K @ C
        P_up = IKC @ P_pred_kal @ _t(IKC) + K @ R @ _t(K)

        if pair_smooth:
            Jg = _t(X[:, 1])                              # P A' P_pred^-1
            f_smp_up = f + Jg @ (f_up - A @ f)
            P_smp_up = P + Jg @ (P_up - P_pred_dyn) @ _t(Jg)
            has_pair = n >= 1
            f_smp = _w(has_pair, f_smp_up, f)
            P_smp = _w(has_pair, P_smp_up, P)
        else:
            f_smp, P_smp = f, P
        f_reg = f_smp if pair_smooth else f

        if update_params and dynamic:
            # both MNIW 1-step updates at once (dim 1 = {internal,
            # observation}); GPI_model.py:1300-1344, n_k == 1 form
            Y1 = torch.stack([f_up, y[..., None]], 1)     # (J, 2, T, 1)
            Y2 = torch.stack([f_reg, f_up], 1)
            V_inv = X[:, 2:4]
            S__h = Y2 @ _t(Y2) + V_inv
            S_x = Y1 @ _t(Y2) + mniw.mean @ V_inv
            S__sym = 0.5 * (S__h + _t(S__h))
            if dtype == torch.float32:
                S__sym = S__sym + (1e-9 * _dmean(S__sym, 1e-30))[
                    ..., None, None] * eye
            L_S2 = linalg.chol(S__sym + 1e-8 * eye)
            part = _t(linalg.cho_solve(L_S2, _t(S_x)))
            n0 = mniw.n0                                   # (J, 2) float64
            new_n0 = n0 + 1.0
            c0 = ((n0 - 2.0) / (new_n0 - 2.0)).to(dtype)[..., None, None]
            c1 = (1.0 / (new_n0 - 2.0)).to(dtype)[..., None, None]
            mean_up = c0 * mniw.mean + c1 * part
            e = Y1 - Y2
            scale_up = c0 * mniw.scale + c1 * (e @ _t(e))
            mniw_up = MNIW(mean_up, S__h, new_n0, scale_up)

            do_mniw = member & (n >= 1) & (N_newf < limit)
            mniw_new = tree_map(lambda a, b: _w(do_mniw, a, b), mniw_up,
                                mniw)
            post_scale = mniw_new.scale * (
                mniw_new.n0 / (mniw_new.n0 - 2.0)).to(dtype)[..., None, None]
            GS_base = _w(n >= 1, post_scale, torch.stack([G, S], 1))
            if annealing:
                anneal = torch.stack([G0diag, S0diag], 1)[..., None, None] \
                    / (N_newf ** 2)[:, None, None, None] * eye
                GS_base = GS_base + anneal
            do_append = member & (N_newf < limit)
            A_out = _w(do_append, mniw_new.mean[:, 0], A)
            C_out = _w(do_append, mniw_new.mean[:, 1], C)
            G_out = _w(do_append, GS_base[:, 0], G)
            S_out = _w(do_append, GS_base[:, 1], S)
            mniw_out = tree_map(lambda a, b: _w(member, a, b), mniw_new,
                                mniw)
        else:
            A_out, G_out, C_out, S_out = A, G, C, S
            mniw_out = mniw

        f_next = _w(member, f_up, f)
        P_next = _w(member, P_up, P)
        f_prevF_next = _w(member, f, f_prevF)
        P_prevF_next = _w(member, P, P_prevF)
        n_out = torch.where(member, N_new, n)
        score_mean = (C_out @ f_next)[..., 0]

        new_carry = (f_next, P_next, f_prevF_next, P_prevF_next,
                     A_out, G_out, C_out, S_out, mniw_out,
                     n_out, noise0, G0diag, S0diag)
        emit = (member, f_next, P_next, A_out, G_out, S_out, score_mean)
        if not full_backward:
            # online builds: the pair-smoothed (or untouched) previous
            # state for the compact-summary gather points
            emit = emit + (f_smp, P_smp)
        return new_carry, emit

    return forward_step


def _run_forward(step, carry, Ys, ms):
    """Loop ``step`` over slots: Ys (J, L, T), ms (J, L). Returns the
    final carry and the emits stacked on dim 1."""
    emits = []
    for s in range(Ys.shape[1]):
        carry, e = step(carry, (Ys[:, s], ms[:, s]))
        emits.append(e)
    return carry, tuple(torch.stack(x, 1) for x in zip(*emits))


def _backward_step(carry, inp):
    f_next_sm, P_next_sm, started = carry
    member, f_t, P_t, A_t, G_t = inp
    f_sm_pair, P_sm_pair = rts_pair(f_t, P_t, f_next_sm, P_next_sm, A_t, G_t)
    f_sm = _w(started, f_sm_pair, f_t)
    P_sm = _w(started, P_sm_pair, P_t)
    new_carry = (_w(member, f_sm, f_next_sm), _w(member, P_sm, P_next_sm),
                 started | member)
    return new_carry, (f_sm, P_sm)


def _run_backward(carry, member, f_filt, P_filt, A_seq, G_seq):
    """Reverse RTS loop over slots (job-first sequences)."""
    L = member.shape[1]
    fs, Ps = [None] * L, [None] * L
    for s in range(L - 1, -1, -1):
        carry, (fs[s], Ps[s]) = _backward_step(
            carry, (member[:, s], f_filt[:, s], P_filt[:, s], A_seq[:, s],
                    G_seq[:, s]))
    return torch.stack(fs, 1), torch.stack(Ps, 1)


class RefitResult(NamedTuple):
    q: torch.Tensor       # (J, N) emission scores (compute_sq_err_all)
    q_lat: torch.Tensor   # (J, N) latent scores (compute_q_lat_all)
    snr: torch.Tensor     # (J, N) SNR vs the closest smoothed state
    state: ClusterState
    lds: torch.Tensor     # (J,) lds_param_elbo of the refit state (0.0
    #                       unless build_refit(free_deg=...) was given)


def build_refit(T: int, est_limit: Optional[int] = None,
                annealing: bool = True, dynamic: bool = True,
                update_params: bool = True, pair_smooth: bool = True,
                full_backward: bool = True, bucket: Optional[int] = None,
                emit_smoothed: bool = False, hybrid: bool = True,
                free_deg: Optional[float] = None):
    """Build the refit for beat length T.

    Returns ``refit(Y, resp, state) -> RefitResult``. Batched: Y
    (J, N, T), resp (J, N) hard responsibilities in {0, 1}, and a state
    whose fields carry a leading job dim (``stack_states``). Given Y
    (N, T), resp (N,) and an unbatched state, it runs one job and
    returns unbatched results, like the reference's ``build_refit``.

    Variants as in the reference: ``update_params=False`` (q_simple: no
    Bayesian update), ``pair_smooth=False`` (online commit),
    ``full_backward=False`` (no final RTS pass), ``bucket`` (scan over
    that many gathered members; the caller guarantees bucket >= number
    of members), ``hybrid`` (sequential head + parallel frozen tail past
    ``est_limit``). With ``emit_smoothed=True`` it returns
    ``(RefitResult, (Y_s, f_sm, P_sm, m_s))``: the member-gathered beats
    (J, Bs, T), the smoothed means (J, Bs, T, 1) and covariances
    (J, Bs, T, T) in slot order, and the slot mask (J, Bs), which the
    ML-EM path consumes (GPI.new_params_LDS works on smoothed moments,
    GPI.py:302-455).
    """
    limit = math.inf if est_limit is None else float(est_limit)
    E_int = None if est_limit is None else max(int(est_limit), 1)
    hybrid_ok = (hybrid and E_int is not None and dynamic and update_params
                 and full_backward)
    forward_step = make_forward_step(T, limit, annealing, dynamic,
                                     update_params, pair_smooth,
                                     full_backward)

    def _refit_core(Y, resp, state: ClusterState) -> RefitResult:
        Jn, N = resp.shape
        dtype, dev = Y.dtype, Y.device
        eye = torch.eye(T, dtype=dtype, device=dev)
        n_before = state.n
        noise0 = state.theta.noise
        G0diag = torch.diagonal(state.Gamma_def, dim1=-2, dim2=-1).mean(-1)
        S0diag = torch.diagonal(state.Sigma_def, dim1=-2, dim2=-1).mean(-1)

        member_full = resp > 0.99
        Bs = N if bucket is None else min(bucket, N)
        # gather members to the front, preserving time order
        perm = torch.argsort(torch.logical_not(member_full).to(torch.int8),
                             dim=1, stable=True)
        midx = perm[:, :Bs]
        Y_s = _take(Y, midx)
        m_s = _take(member_full, midx).to(dtype)

        mniw0 = tree_map(lambda a, b: torch.stack([a, b], 1),
                         state.mniw_int, state.mniw_obs)
        carry0 = (state.f_last, state.P_last, state.f_prev, state.P_prev,
                  state.A, state.Gamma, state.C, state.Sigma,
                  mniw0, state.n, noise0, G0diag, S0diag)
        take_hybrid = hybrid_ok and Bs > E_int and (
            dtype != torch.float32 or Bs - E_int >= 128)
        if take_hybrid:
            # sequential head (parameter updates live) + parallel frozen
            # tail: past slot E_int every update condition is False
            Hh = E_int
            Bt = Bs - Hh
            carryF, emitsH = _run_forward(forward_step, carry0,
                                          Y_s[:, :Hh], m_s[:, :Hh])
            (f_lastF, P_lastF, f_prevF, P_prevF, A_f, G_f, C_f, S_f,
             mniw_f, n_head, *_aux) = carryF
            (member_h, f_filt_h, P_filt_h, A_seq_h, G_seq_h, S_seq_h,
             score_mean_h) = emitsH
            member_t = m_s[:, Hh:] > 0.5
            mb_all = member_full.sum(1)
            anchor = (Hh + torch.arange(Bt, device=dev))[None] \
                >= (mb_all - 1)[:, None]
            if dtype == torch.float32 and Bt >= 128:
                f_filt_t, P_filt_t, f_sm_t, P_sm_t = _tail_steady(
                    Y_s[:, Hh:], member_t, f_lastF, P_lastF,
                    A_f, G_f, C_f, S_f, anchor)
            else:
                f_filt_t, P_filt_t = _tail_filter(
                    Y_s[:, Hh:], member_t, f_lastF, P_lastF,
                    A_f, G_f, C_f, S_f)
                f_sm_t, P_sm_t = _tail_smooth(f_filt_t, P_filt_t,
                                              A_f, G_f, anchor)
            has_tail = mb_all > Hh
            carryB0 = (_w(has_tail, f_sm_t[:, 0], f_lastF),
                       _w(has_tail, P_sm_t[:, 0], P_lastF), has_tail)
            f_sm_h, P_sm_h = _run_backward(carryB0, member_h, f_filt_h,
                                           P_filt_h, A_seq_h, G_seq_h)

            def tail_rep(M):
                return M[:, None].expand(Jn, Bt, T, T)

            f_filt = torch.cat([f_filt_h, f_filt_t], 1)
            P_filt = torch.cat([P_filt_h, P_filt_t], 1)
            A_seq = torch.cat([A_seq_h, tail_rep(A_f)], 1)
            G_seq = torch.cat([G_seq_h, tail_rep(G_f)], 1)
            S_seq = torch.cat([S_seq_h, tail_rep(S_f)], 1)
            score_mean = torch.cat(
                [score_mean_h, f_filt_t[..., 0] @ _t(C_f)], 1)
            f_sm = torch.cat([f_sm_h, f_sm_t], 1)
            P_sm = torch.cat([P_sm_h, P_sm_t], 1)
            f_smp, P_smp = f_filt, P_filt
            n_f = (n_head + member_t.sum(1)).to(torch.int32)
            idxp = torch.clamp(mb_all - 2, 0, Bs - 1)
            f_prevF = _w(mb_all > Hh, _take1(f_filt, idxp), f_prevF)
            P_prevF = _w(mb_all > Hh, _take1(P_filt, idxp), P_prevF)
        else:
            carryF, emits = _run_forward(forward_step, carry0, Y_s, m_s)
            (member, f_filt, P_filt, A_seq, G_seq, S_seq,
             score_mean) = emits[:7]
            f_smp, P_smp = (emits[7], emits[8]) if not full_backward \
                else (f_filt, P_filt)
            (f_lastF, P_lastF, f_prevF, P_prevF, A_f, G_f, C_f, S_f,
             mniw_f, n_f, *_aux) = carryF
            if dynamic and full_backward:
                carryB0 = (f_lastF, P_lastF,
                           torch.zeros(Jn, dtype=torch.bool, device=dev))
                f_sm, P_sm = _run_backward(carryB0, member, f_filt, P_filt,
                                           A_seq, G_seq)
            else:
                f_sm, P_sm = f_filt, P_filt
        m_int_f = tree_map(lambda a: a[:, 0], mniw_f)
        m_obs_f = tree_map(lambda a: a[:, 1], mniw_f)

        # ---- emission scores (compute_sq_err_all parity) ----
        memberi = member_full.to(torch.int32)
        pos = torch.cumsum(memberi, 1) - 1
        n_members = memberi.sum(1)
        slot_self = torch.clamp(pos, 0, Bs - 1)
        slot_nonmember = torch.clamp(torch.clamp(pos, min=1) - 1, 0, Bs - 1)
        gather_slot = torch.where(member_full, slot_self, slot_nonmember)
        first_member = member_full & (pos == 0)

        # one factor per distinct slot covariance: past the estimation
        # limit every slot carries the same frozen Sigma
        De = Bs if E_int is None else min(Bs, E_int + 1)
        Sd = S_seq[:, :De]
        Sd = 0.5 * (Sd + _t(Sd))
        # extra factor slot [De]: the first-member variant of slot 0
        S0v = Sd[:, 0] + (1e-2 * S0diag)[:, None, None] * eye
        Sd = torch.cat([Sd, S0v[:, None]], 1)
        dm = _dmean(Sd, torch.finfo(dtype).eps)
        L_slots = linalg.chol(Sd + (1e-8 * dm)[..., None, None] * eye)
        fac_idx = torch.where(first_member, De,
                              torch.clamp(gather_slot, max=De - 1))
        diff = (Y - _take(score_mean, gather_slot))[..., None]
        sol = linalg.solve_lower(_take(L_slots, fac_idx), diff)
        q = -0.5 * torch.sum(sol[..., 0] ** 2, -1) - 0.5 * T * LOG2PI
        q = _w(n_members > 0, q, torch.zeros_like(q))

        # ---- latent scores (compute_q_lat_all parity), per slot then
        # scattered back to time ----
        member_s = m_s > 0.5
        if dynamic:
            slots = torch.arange(Bs, device=dev)
            prev_slot = torch.clamp(slots - 1, 0, Bs - 1)
            is_first = (slots == 0)[None, :, None, None]
            lat_prev = torch.where(is_first, f_sm, f_sm[:, prev_slot])
            cov_prev = torch.where(is_first, P_sm, P_sm[:, prev_slot])
            A_j = torch.where(is_first, A_f[:, None], A_seq)
            # slot 0 uses the FINAL (A_f, G_f); slots past the limit the
            # frozen pair: only De distinct (A, G)
            Gd = torch.cat([G_f[:, None], G_seq[:, 1:De]], 1)
            Ad = torch.cat([A_f[:, None], A_seq[:, 1:De]], 1)
            Gd = 0.5 * (Gd + _t(Gd))
            gd = _dmean(Gd, torch.finfo(dtype).eps)
            L2d = linalg.chol(Gd + (1e-8 * gd)[..., None, None] * eye)
            GAd = linalg.cho_solve(L2d, Ad)
            idx_lat = torch.where(slots == 0, 0,
                                  torch.clamp(slots, max=De - 1))
            resid = f_sm - A_j @ lat_prev
            s2 = linalg.solve_lower(L2d[:, idx_lat], resid)
            mh = torch.sum(s2[..., 0] ** 2, -1)
            tr = torch.sum(Ad[:, idx_lat] * (GAd[:, idx_lat] @ cov_prev),
                           dim=(-2, -1))
            q_lat_slot = -0.5 * (mh + tr) - 0.5 * T * LOG2PI
            q_lat_slot = torch.where(member_s & (n_members > 0)[:, None],
                                     q_lat_slot,
                                     torch.zeros_like(q_lat_slot))
            q_lat = torch.zeros((Jn, N), dtype=dtype, device=dev).scatter(
                1, midx, q_lat_slot)
        else:
            q_lat = torch.zeros((Jn, N), dtype=dtype, device=dev)

        # ---- SNR vs closest smoothed state (GPI_HDP.compute_snr) ----
        j_idx = torch.minimum(torch.clamp(pos, min=1),
                              torch.clamp(n_members, min=1)[:, None])
        snr_slot = torch.clamp(j_idx - 1, 0, Bs - 1)
        f_tgt = _take(f_sm, snr_slot)[..., 0]
        num = torch.sum(f_tgt ** 2, -1)
        den = torch.sum((f_tgt - Y) ** 2, -1)
        snr = 10.0 * (torch.log10(torch.clamp(num, min=1e-300))
                      - torch.log10(torch.clamp(den, min=1e-300)))

        # ---- compact state summary ----
        mb = n_members
        idx_last = torch.clamp(mb - 1, 0, Bs - 1)
        idx_prev = torch.clamp(mb - 2, 0, Bs - 1)
        idx_prev2 = torch.clamp(mb - 3, 0, Bs - 1)
        zero = torch.zeros_like(mb)

        def sel3(cond_pairs, default):
            out = default
            for cond, val in reversed(cond_pairs):
                out = _w(cond, val, out)
            return out

        f_sm_prev_new = sel3(
            [(mb >= 2, _take1(f_sm, idx_prev)),
             ((mb == 1) & (n_before >= 1), _take1(f_smp, idx_last))],
            state.f_sm_prev)
        P_sm_prev_new = sel3(
            [(mb >= 2, _take1(P_sm, idx_prev)),
             ((mb == 1) & (n_before >= 1), _take1(P_smp, idx_last))],
            state.P_sm_prev)
        f_sm_prev2_new = sel3(
            [(mb >= 3, _take1(f_sm, idx_prev2)),
             ((mb == 2) & (n_before >= 1), _take1(f_smp, idx_prev)),
             (mb == 1, state.f_sm_prev)],
            state.f_sm_prev2)
        P_sm_prev2_new = sel3(
            [(mb >= 3, _take1(P_sm, idx_prev2)),
             ((mb == 2) & (n_before >= 1), _take1(P_smp, idx_prev)),
             (mb == 1, state.P_sm_prev)],
            state.P_sm_prev2)
        f_sm_first_new = sel3(
            [((n_before == 0) & (mb >= 1), _take1(f_sm, zero)),
             ((n_before == 1) & (mb >= 1), _take1(f_smp, zero))],
            state.f_sm_first)
        P_sm_first_new = sel3(
            [((n_before == 0) & (mb >= 1), _take1(P_sm, zero)),
             ((n_before == 1) & (mb >= 1), _take1(P_smp, zero))],
            state.P_sm_first)
        A_prev_new = sel3(
            [(mb >= 2, _take1(A_seq, idx_prev)), (mb == 1, state.A)],
            state.A_prev)
        G_prev_new = sel3(
            [(mb >= 2, _take1(G_seq, idx_prev)), (mb == 1, state.Gamma)],
            state.Gamma_prev)

        has = mb > 0
        has2 = n_f > 1

        def pick(arr, idx, default):
            return _w(has, _take1(arr, idx), default)

        new_state = state._replace(
            n=n_f.to(torch.int32),
            f_last=pick(f_filt, idx_last, state.f_last),
            P_last=pick(P_filt, idx_last, state.P_last),
            f_prev=_w(has & has2, f_prevF, state.f_prev),
            P_prev=_w(has & has2, P_prevF, state.P_prev),
            f_sm_last=pick(f_sm, idx_last, state.f_sm_last),
            P_sm_last=pick(P_sm, idx_last, state.P_sm_last),
            f_sm_prev=f_sm_prev_new, P_sm_prev=P_sm_prev_new,
            f_sm_prev2=f_sm_prev2_new, P_sm_prev2=P_sm_prev2_new,
            f_sm_first=f_sm_first_new, P_sm_first=P_sm_first_new,
            A=A_f, Gamma=G_f, C=C_f, Sigma=S_f,
            A_prev=A_prev_new, Gamma_prev=G_prev_new,
            mniw_int=m_int_f, mniw_obs=m_obs_f,
        )
        if free_deg is not None:
            lds_val = lds_param_elbo(new_state, float(free_deg))
        else:
            lds_val = torch.zeros((Jn,), dtype=dtype, device=dev)
        result = RefitResult(q=q, q_lat=q_lat, snr=snr, state=new_state,
                             lds=lds_val)
        if emit_smoothed:
            return result, (Y_s, f_sm, P_sm, m_s)
        return result

    def refit(Y, resp, state: ClusterState):
        if Y.ndim == 2:
            out = _refit_core(Y[None], resp[None], stack_states([state]))
            if emit_smoothed:
                res, smoothed = out
                return (tree_map(lambda x: x[0], res),
                        tuple(x[0] for x in smoothed))
            return tree_map(lambda x: x[0], out)
        return _refit_core(Y, resp, state)

    return refit


def lds_param_elbo(state: ClusterState, free_deg) -> torch.Tensor:
    """return_LDS_param_likelihood parity (GPI_model.py:459-486): MNIW
    log-density of (A, Gamma) and (C, Sigma) under fresh priors
    anchored at the defaults, scaled by /T * 100. Gamma term dropped
    when the default Gamma is all-zero (static model). Batched over
    leading dims."""
    T = state.A.shape[-1]
    eye = _eye(T, state.A).expand_as(state.A)
    int_prior = MNIW(state.A_def, eye, free_deg, state.Gamma_def)
    obs_prior = MNIW(state.C_def, eye, free_deg, state.Sigma_def)
    lik_AG = mniw_ops.log_likelihood(int_prior, state.A, state.Gamma)
    lik_AG = torch.where(torch.any(state.Gamma_def != 0.0, dim=-1).any(-1),
                         lik_AG, torch.zeros_like(lik_AG))
    lik_CS = mniw_ops.log_likelihood(obs_prior, state.C, state.Sigma)
    return (lik_AG + lik_CS) / T * 100.0


# ---------------------------------------------------------------------------
# Online single-sample primitives (include_sample and the stream engine).
# Each broadcasts over the leading (job / slot) dims of the state; y is
# (..., T) and broadcasts against them.
# ---------------------------------------------------------------------------

def log_sq_error_last(state: ClusterState, y: torch.Tensor) -> torch.Tensor:
    """Score a new beat against the cluster's last state
    (GPI_model.log_sq_error with i=-1: mean = C f_last, cov = Sigma)."""
    mean = (state.C @ state.f_last)[..., 0]
    return linalg.gaussian_score(y - mean, state.Sigma)


def estimate_new(state: ClusterState, y: torch.Tensor) -> torch.Tensor:
    """Score assuming the beat were included (GPI_HDP.estimate_new,
    GPI_HDP.py:2830-2842): posterior update with the current parameters
    (kalman_step; its solve stays torch.linalg, as it was XLA in the
    reference), then the score against the posterior mean, inflated
    when the cluster has exactly one member (GPI_HDP.py:2836)."""
    f_up, _ = kalman_step(state.f_last, state.P_last, y[..., None],
                          LDSParams(state.A, state.Gamma, state.C,
                                    state.Sigma),
                          state.n == 0, noise_first=state.theta.noise)
    mean = (state.C @ f_up)[..., 0]
    eye = _eye(mean.shape[-1], mean)
    infl = 1e-2 * torch.diagonal(state.Sigma_def, dim1=-2, dim2=-1).mean(-1)
    infl = torch.where(state.n == 1, infl, torch.zeros_like(infl))
    return linalg.gaussian_score(y - mean,
                                 state.Sigma + infl[..., None, None] * eye)


def q_lat_tail(state: ClusterState, h_ini=1.0):
    """Latent-score patch values for the (first, second-to-last, last)
    members from the compact summary (log_lat_error semantics,
    GPI_model.py:288-323); the caller scatters them at those members'
    time indices, the only q_lat entries an online step can change.
    ``h_ini`` is a float or a tensor of the leading shape."""

    def score(lat_cur, lat_prev, cov_prev, A_, G_):
        resid = lat_cur - A_ @ lat_prev
        L = linalg.chol_spd(G_)
        sol = linalg.solve_lower(L, resid)
        mahal = torch.sum(sol ** 2, (-2, -1))
        trace = torch.sum(A_ * (linalg.cho_solve(L, A_) @ cov_prev),
                          (-2, -1))
        return -0.5 * (mahal + trace) - 0.5 * resid.shape[-2] * LOG2PI

    h = h_ini[..., None, None] if torch.is_tensor(h_ini) else h_ini
    val_first = score(state.f_sm_first, state.f_sm_first, state.P_sm_first,
                      state.A, state.Gamma * h)
    val_prev = score(state.f_sm_prev, state.f_sm_prev2, state.P_sm_prev2,
                     state.A_prev, state.Gamma_prev)
    val_last = score(state.f_sm_last, state.f_sm_prev, state.P_sm_prev,
                     state.A, state.Gamma)
    return val_first, val_prev, val_last


# ---------------------------------------------------------------------------
# GP observation / resampling APIs (IterativeGaussianProcess surface,
# gplds.py:1093-1195). One unbatched cluster state each; the grids are
# taken to the state's device and dtype.
# ---------------------------------------------------------------------------

def _grid(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype,
                           device=like.device).reshape(-1)


def _same_grid(x_post: torch.Tensor, x_basis: torch.Tensor):
    """A device bool (no host read) when the two grids have one length,
    else None."""
    if x_post.shape[0] != x_basis.shape[0]:
        return None
    return torch.all(x_post == x_basis)


def observe(state: ClusterState, x_post, x_basis,
            use_smoothed: bool = False):
    """The emission distribution at arbitrary inputs x_post through the
    GP projection K(x*, X) K(X, X)^-1 (GPI.pred_dist, GPI.py:457-503);
    on the shared grid it is (C f, Sigma). The Grams are kernel A on the
    card (ops/kernels.gram)."""
    f = state.f_sm_last if use_smoothed else state.f_last
    mean = state.C @ f
    x_post, x_basis = _grid(x_post, mean), _grid(x_basis, mean)
    same = _same_grid(x_post, x_basis)
    K_XX = gram(state.theta, x_basis, x_basis)
    K_XXs = gram(state.theta, x_basis, x_post)
    K_XsXs = gram(state.theta, x_post, include_noise=True)
    jitter = 1e-4 * linalg.diag_mean(state.Sigma)
    L = linalg.chol(linalg.sym(K_XX) + jitter * _eye(K_XX.shape[0], mean))
    K_solve = linalg.cho_solve(L, K_XXs)
    f_star = _t(K_solve) @ mean
    cov_f = K_XsXs - _t(K_XXs) @ K_solve + _t(K_solve) @ state.Sigma \
        @ K_solve
    cov_f = linalg.sym(cov_f) + 1e-6 * _eye(cov_f.shape[0], mean)
    if same is not None:
        f_star = torch.where(same, mean, f_star)
        cov_f = torch.where(same, state.Sigma, cov_f)
    return f_star, cov_f


def observe_latent(state: ClusterState, x_post, x_basis,
                   use_smoothed: bool = True):
    """The LATENT state distribution at arbitrary inputs
    (GPI.pred_latent_dist, GPI.py:505-562), with the reference's fixed
    1e-4 kernel jitter; on the shared grid the stored latent moments."""
    f = state.f_sm_last if use_smoothed else state.f_last
    P = state.P_sm_last if use_smoothed else state.P_last
    x_post, x_basis = _grid(x_post, f), _grid(x_basis, f)
    same = _same_grid(x_post, x_basis)
    K_XX = gram(state.theta, x_basis, x_basis)
    K_XXs = gram(state.theta, x_basis, x_post)
    K_XsX = _t(K_XXs)
    K_XsXs = gram(state.theta, x_post, x_post)
    L = linalg.chol(K_XX + 1e-4 * _eye(K_XX.shape[0], f))
    f_star = K_XsX @ linalg.cho_solve(L, f)
    sol_K = linalg.cho_solve(L, K_XXs)
    term_data = K_XsX @ sol_K
    term_prior = K_XsX @ linalg.cho_solve(L, P @ sol_K)
    cov_f = K_XsXs - term_data + term_prior
    if same is not None:
        f_star = torch.where(same, f, f_star)
        cov_f = torch.where(same, P, cov_f)
    return f_star, cov_f


def _observation_moments(st: ClusterState):
    """y ~ N(C f_sm, sym(C P_sm C' + Sigma))."""
    mu = (st.C @ st.f_sm_last)[..., 0]
    return mu, linalg.sym(st.C @ st.P_sm_last @ _t(st.C) + st.Sigma)


def _sample_from_normals(state: ClusterState, z: torch.Tensor
                         ) -> torch.Tensor:
    """mean + z L' for standard normals z (n, T), L = chol_spd(cov)."""
    mean, cov = _observation_moments(state)
    return mean[None, :] + z @ _t(linalg.chol_spd(cov))


def sample_observations(state: ClusterState, generator: torch.Generator,
                        n_samples: int = 1) -> torch.Tensor:
    """Draw beats from the cluster's current observation distribution
    y ~ N(C f_sm, C P_sm C' + Sigma) (GPI.sample_y, GPI.py:564-608).
    ``generator`` lives on the state's device."""
    T = state.f_sm_last.shape[-2]
    z = torch.randn((n_samples, T), generator=generator,
                    dtype=state.f_sm_last.dtype,
                    device=state.f_sm_last.device)
    return _sample_from_normals(state, z)


def kl_divergence(state_a: ClusterState, state_b: ClusterState
                  ) -> torch.Tensor:
    """Symmetric KL between two clusters' observation distributions
    (GPI.KL_divergence, GPI.py:1058-1094)."""
    mu1, c1 = _observation_moments(state_a)
    mu2, c2 = _observation_moments(state_b)
    ic1 = linalg.inv_spd(c1)
    ic2 = linalg.inv_spd(c2)
    tr = (torch.trace(ic2 @ c1 + ic1 @ c2) - 2 * c1.shape[0]) / 4.0
    d = mu1 - mu2
    return torch.dot(d, (ic1 + ic2) @ d) / 4.0 + tr
