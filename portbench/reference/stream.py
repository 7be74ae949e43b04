"""Plain float64 step of the online stream engine: one beat's decision
(absorb into the first cluster, in order of score, whose candidate
total beats the birth's; else a birth, gated by the birth's score
beating every cluster's), the commit into the chosen cluster, and the
one-sample accounting (selected emission and latent scores, linear
ELBO terms, cluster parameter terms), followed from the engine's own
state before the beat, with each live cluster's kernel fitted again on
the beat that seeded it."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference import gplds as G
from portbench.reference import hdp
from portbench.reference import kernel_fit
from portbench.reference import precision
from portbench.reference.offline import frob_rel, rel

F64 = torch.float64
COMMITTED = ("f_last", "P_last", "A", "Gamma", "C", "Sigma")
SUMMARY = ("n", "f_last", "P_last", "f_prev", "P_prev", "f_sm_last",
           "P_sm_last", "f_sm_prev", "P_sm_prev", "f_sm_prev2",
           "P_sm_prev2", "f_sm_first", "P_sm_first", "A", "Gamma", "C",
           "Sigma", "A_prev", "Gamma_prev", "A_def", "Gamma_def", "C_def",
           "Sigma_def")


def slot_summary(states, k: int, dtype=F64) -> Dict:
    """Slot k of the engine's stacked cluster states, in ``dtype``."""
    d = {name: getattr(states, name)[k].to(dtype) for name in SUMMARY}
    d["n"] = int(states.n[k])
    th = states.theta
    d["outputscale"] = th.outputscale[k].to(dtype)
    d["lengthscale"] = th.lengthscale[k].to(dtype)
    d["noise"] = th.noise[k].to(dtype)
    mi, mo = states.mniw_int, states.mniw_obs
    d["mniw"] = (torch.stack([mi.mean[k], mo.mean[k]]).to(dtype),
                 torch.stack([mi.row_cov[k], mo.row_cov[k]]).to(dtype),
                 torch.stack([mi.n0[k], mo.n0[k]]).to(dtype),
                 torch.stack([mi.scale[k], mo.scale[k]]).to(dtype))
    return d


def _cluster(s: Dict) -> G.Cluster:
    mean, row_cov, n0, scale = s["mniw"]
    return G.Cluster(theta_noise=s["noise"], K0=None,
                     Gamma_def=s["Gamma_def"], Sigma_def=s["Sigma_def"],
                     n=s["n"], f=s["f_last"], P=s["P_last"], A=s["A"],
                     Gamma=s["Gamma"], C=s["C"], Sigma=s["Sigma"],
                     mniw_mean=mean, mniw_row_cov=row_cov, mniw_n0=n0,
                     mniw_scale=scale)


def append(s: Dict, y, limit, update_params: bool, pair_smooth: bool
           ) -> Dict:
    """Include one beat into a cluster summary: the member step, then
    the summary's bookkeeping (last, previous and first states,
    filtered and smoothed)."""
    o = G.member_step(_cluster(s), y, limit, update_params=update_params,
                      pair_smooth=pair_smooth)
    nb = s["n"]
    out = dict(s)
    out.update(
        n=nb + 1, f_last=o.f, P_last=o.P,
        f_prev=s["f_last"] if nb + 1 > 1 else s["f_prev"],
        P_prev=s["P_last"] if nb + 1 > 1 else s["P_prev"],
        f_sm_last=o.f, P_sm_last=o.P,
        f_sm_prev=o.f_smp if nb >= 1 else s["f_sm_prev"],
        P_sm_prev=o.P_smp if nb >= 1 else s["P_sm_prev"],
        f_sm_prev2=s["f_sm_prev"], P_sm_prev2=s["P_sm_prev"],
        f_sm_first=(o.f if nb == 0 else
                    o.f_smp if nb == 1 else s["f_sm_first"]),
        P_sm_first=(o.P if nb == 0 else
                    o.P_smp if nb == 1 else s["P_sm_first"]),
        A=o.A, Gamma=o.Gamma, C=o.C, Sigma=o.Sigma,
        A_prev=s["A"], Gamma_prev=s["Gamma"], mniw=o.mniw)
    return out


def _k0(s: Dict, x):
    return G.rbf(x, s["outputscale"], s["lengthscale"])


def reinit(s: Dict, x, free_deg: float) -> Dict:
    """The cluster's dynamics back to its defaults, its kernel kept."""
    T = x.shape[0]
    I = G.eye(T, x)
    z = torch.zeros((T, 1), dtype=x.dtype, device=x.device)
    K0 = _k0(s, x)
    out = dict(s)
    for k in ("f_last", "f_prev", "f_sm_last", "f_sm_prev", "f_sm_prev2",
              "f_sm_first"):
        out[k] = z
    for k in ("P_last", "P_prev", "P_sm_last", "P_sm_prev", "P_sm_prev2",
              "P_sm_first"):
        out[k] = K0
    out.update(n=0, A=s["A_def"], Gamma=s["Gamma_def"], C=s["C_def"],
               Sigma=s["Sigma_def"], A_prev=s["A_def"],
               Gamma_prev=s["Gamma_def"],
               mniw=(torch.stack([s["A_def"], s["C_def"]]),
                     torch.stack([I, I]),
                     torch.full((2,), float(free_deg), dtype=x.dtype,
                                device=x.device),
                     torch.stack([s["Gamma_def"], s["Sigma_def"]])))
    return out


def apply_fit(s: Dict, x, outputscale, noise) -> Dict:
    """The cluster after a kernel fit: new kernel, zero mean, the Gram as
    covariance, A = C = I, Gamma and Sigma made diagonal."""
    T = x.shape[0]
    I = G.eye(T, x)
    out = dict(s, outputscale=outputscale, noise=noise)
    K0 = _k0(out, x)
    S = s["Sigma"][0, 0] * I
    Gm = torch.diagonal(s["Gamma"]).mean() * I
    z = torch.zeros((T, 1), dtype=x.dtype, device=x.device)
    for k in ("f_last", "f_prev", "f_sm_last", "f_sm_prev", "f_sm_prev2",
              "f_sm_first"):
        out[k] = z
    for k in ("P_last", "P_prev", "P_sm_last", "P_sm_prev", "P_sm_prev2",
              "P_sm_first"):
        out[k] = K0
    mean, row_cov, n0, _scale = s["mniw"]
    out.update(Sigma_def=S, A=I, C=I, Gamma=Gm, Sigma=S, A_prev=I,
               Gamma_prev=Gm,
               mniw=(torch.stack([I, I]), row_cov, n0,
                     torch.stack([Gm, S])))
    return out


def score_last(s: Dict, y):
    return G.gaussian_score(y - (s["C"] @ s["f_last"])[:, 0], s["Sigma"])


def estimate_new(s: Dict, y):
    """Score of the beat against the cluster's posterior mean had it
    been included with the current parameters (covariance inflated by
    1e-2 mean(diag Sigma_def) when the cluster has one member)."""
    T = y.shape[0]
    I = G.eye(T, y)
    first = s["n"] == 0
    A, C = s["A"], s["C"]
    m = A @ s["f_last"]
    P_pred = s["P_last"] if first else A @ s["P_last"] @ G.t_(A) \
        + s["Gamma"]
    y_pred = torch.zeros_like(m) if first else C @ m
    R = s["noise"] * I if first else s["Sigma"]
    S_in = C @ P_pred @ G.t_(C) + R
    K = G.t_(G.cho_solve(G.chol(S_in), C @ G.t_(P_pred)))
    f_up = m + K @ (y[:, None] - y_pred)
    infl = 1e-2 * torch.diagonal(s["Sigma_def"]).mean() if s["n"] == 1 \
        else 0.0
    return G.gaussian_score(y - (C @ f_up)[:, 0], s["Sigma"] + infl * I)


def q_lat_tail(s: Dict, h: float):
    """Latent scores of the first, second-to-last and last members."""
    def score(cur, prev, cov, A, Gm):
        T = cur.shape[0]
        L = G.chol(G.jitter(Gm, 1e-8))
        r = G.solve_lower(L, cur - A @ prev)
        tr = torch.sum(A * (G.cho_solve(L, A) @ cov))
        return -0.5 * (torch.sum(r ** 2) + tr) - 0.5 * T * G.LOG2PI

    return (score(s["f_sm_first"], s["f_sm_first"], s["P_sm_first"],
                  s["A"], s["Gamma"] * h),
            score(s["f_sm_prev"], s["f_sm_prev2"], s["P_sm_prev2"],
                  s["A_prev"], s["Gamma_prev"]),
            score(s["f_sm_last"], s["f_sm_prev"], s["P_sm_prev"],
                  s["A"], s["Gamma"]))


def lds(s: Dict):
    return G.lds_param_elbo(s["A"], s["Gamma"], s["C"], s["Sigma"],
                            s["Gamma_def"], s["Sigma_def"], s["A_def"],
                            s["C_def"])


def fit_seeds(seed_beats: Dict[int, np.ndarray], cfg: Dict, device,
              dtype=F64) -> Dict[int, tuple]:
    """Each cluster's kernel fitted on the beat that seeded it, by the
    cluster's stable id: {uid: (outputscale, noise)}."""
    uids = sorted(seed_beats)
    Y = torch.as_tensor(np.stack([seed_beats[u] for u in uids]),
                        dtype=dtype, device=device)
    x = torch.arange(Y.shape[1], dtype=dtype, device=device)
    os_, nz = kernel_fit.fit(x, Y, cfg["bound_lo"], cfg["bound_hi"],
                             cfg["fit_iters"], cfg["fit_lr"])
    return {u: (os_[i], nz[i]) for i, u in enumerate(uids)}


def step(carry, y, cfg: Dict, thetas: Dict[int, tuple], dtype=F64
         ) -> Dict:
    """The engine's step from its state ``carry`` before the beat y (T,),
    in ``dtype`` (the accounting in float64 NumPy), each live cluster's
    kernel, and a first member's, taken from ``thetas`` {uid:
    (outputscale, noise)} (a first member it lacks is fitted here).
    ``cfg``: K, est_limit,
    free_deg, the HDP constants, max_models, the fit's bounds,
    iterations, learning rate and pinned lengthscale. Returns the
    decision (birth, slot, uid), the accounting increments (q_add,
    qlat_add) and the committed cluster."""
    y = y.to(dtype)
    T = y.shape[0]
    x = torch.arange(T, dtype=dtype, device=y.device)
    K = cfg["K"]
    limit = math.inf if cfg["est_limit"] is None else float(cfg["est_limit"])
    fd = float(cfg["free_deg"])
    hc = dict(gamma=cfg["gamma"], trans_alpha=cfg["trans_alpha"],
              start_alpha=cfg["start_alpha"], kappa=cfg["kappa"])
    M = int(carry.M)
    t = int(carry.t)
    n_all = carry.n.cpu().numpy().astype(np.float64)
    cap = min(K, cfg["max_models"])
    slots = [slot_summary(carry.states, k, dtype) for k in range(K)]
    for k in range(M):
        os_, nz = thetas[int(carry.slot_uid[k])]
        slots[k].update(outputscale=os_.to(dtype), noise=nz.to(dtype))
    q_sel = float(carry.q_sel_sum)
    qlat_sel = float(carry.qlat_sel_sum)
    last_t = carry.last_t.cpu().numpy()
    qlat_last = carry.qlat_last.double().cpu().numpy()
    prev_state = int(carry.prev_state)
    rho = carry.rho.cpu().numpy()
    omega = carry.omega.cpu().numpy()
    M_rho = int(carry.M_rho)
    sc = carry.start_counts.double().cpu().numpy()
    tc = carry.trans_counts.double().cpu().numpy()

    def lin(Mx, tcx):
        return hdp.online_lin(rho, omega, Mx, M_rho, sc[:Mx + 1],
                              tcx[:Mx + 1, :Mx + 1], **hc)

    scores = np.array([float(score_last(slots[k], y)) if k < M else -1e30
                       for k in range(K)])
    m_best = int(np.argmax(scores))
    ests = np.array([float(estimate_new(slots[k], y)) for k in range(M)])
    cands = [append(slots[k], y, limit, True, True) for k in range(M)]
    tails = [[float(v) for v in q_lat_tail(c, 1.0)] for c in cands]
    lds_cand = np.array([float(lds(c)) for c in cands])
    lds_slot = np.array([float(lds(slots[k])) for k in range(M)])
    order = np.argsort(-np.where(np.arange(K) < M, scores, -np.inf),
                       kind="stable")
    m_template = int(order[max(M - 1, 0)])
    btempl = reinit(slots[m_template], x, fd)
    est_b = float(estimate_new(btempl, y))
    b_state = append(btempl, y, limit, False, False)
    vf_b5 = float(q_lat_tail(b_state, 0.5)[0]) * 5.0
    lds_b = float(lds(b_state))

    nM = n_all[:M]
    tot_n = float(np.sum(nM))
    sum_lds_n = float(np.sum(np.where(nM > 0, lds_slot * nM, 0.0)))
    base_total = q_sel + qlat_sel + lin(M, tc) \
        + sum_lds_n / max(tot_n, 1e-300)
    gate = est_b > np.max(scores) and t > 0 and M < cap
    tc_b = tc.copy()
    tc_b[prev_state, M] += 1.0
    birth_total = (q_sel + est_b) + (qlat_sel + vf_b5) + lin(M + 1, tc_b) \
        + (sum_lds_n + lds_b) / (tot_n + 1.0) - base_total
    absorb = np.full(K, -np.inf)
    d_prev = np.zeros(K)
    ptv = np.zeros(K)
    for k in range(M):
        vf, vp, vl = tails[k]
        ptv[k] = vl if n_all[k] >= 1 else vf
        pnew = vp if n_all[k] >= 2 else vf
        if last_t[k] == t - 1:
            d_prev[k] = pnew - qlat_last[k]
        tck = tc.copy()
        tck[prev_state, k] += 1.0
        absorb[k] = (q_sel + ests[k]) + (qlat_sel + ptv[k] + d_prev[k]) \
            + lin(M, tck) + (sum_lds_n - lds_slot[k] * nM[k]
                             + lds_cand[k] * (nM[k] + 1.0)) / (tot_n + 1.0) \
            - base_total
    wins = [bool(absorb[order[i]] > birth_total) and i < M
            for i in range(K)]
    any_win = any(wins)
    first_win = int(order[wins.index(True)]) if any_win else int(order[0])
    win = gate and any_win
    chosen = first_win if win else m_best
    birth = gate and not any_win
    slot = M if birth else chosen
    uid = int(carry.uid_next) if birth else int(carry.slot_uid[slot])
    src = slots[slot]
    if src["n"] == 0 and not bool(carry.fitted[slot]):
        if uid in thetas:
            os_, nz = thetas[uid]
        else:
            os_, nz = (v[0] for v in kernel_fit.fit(
                x, y[None], cfg["bound_lo"], cfg["bound_hi"],
                cfg["fit_iters"], cfg["fit_lr"]))
        src = dict(src, lengthscale=torch.tensor(cfg["pin_lengthscale"],
                                                 dtype=dtype,
                                                 device=y.device))
        src = apply_fit(src, x, os_.to(dtype), nz.to(dtype))
    committed = append(src, y, limit, True, False)
    if birth:
        q_add, qlat_add = est_b, vf_b5
    elif win:
        q_add, qlat_add = ests[chosen], ptv[chosen] + d_prev[chosen]
    else:
        q_add, qlat_add = scores[chosen], 0.0
    return dict(birth=birth, slot=slot, uid=uid, q_add=float(q_add),
                qlat_add=float(qlat_add), committed=committed,
                birth_total=float(birth_total),
                absorb_total=absorb[:M].copy())


def _glob_rel(a: Dict, b) -> float:
    return max(rel(a["rho"], b.rho, 1e-300), rel(a["omega"], b.omega, 1e-300),
               rel(a["trans_theta"], b.trans_theta, 1e-300),
               rel(a["start_theta"], b.start_theta, 1e-300))


def check(cap: Dict, cfg: Dict, device, control: bool = False
          ) -> Dict[str, float]:
    """``cap``: sampled ``steps`` [(carry before, beat, carry after, the
    step's output)], the window's HDP ``refreshes`` [(M, start counts,
    trans counts, globals before, globals after)] and ``seed_beats``
    {cluster id: the beat its kernel was fitted on}. Returns each
    compared number: the decisions (birth, cluster) that differ, the
    committed cluster's largest relative gap, the accounting increments'
    (selected emission and latent scores), the refreshed globals'. Each
    reads inf when nothing was captured to compare. With ``control``
    the reference in float32 with TF32 products stands in the program's
    place."""
    inf = dict(decisions=math.inf, commit=math.inf, accounting=math.inf,
               hdp=math.inf)
    if not cap["steps"]:
        return inf
    live = {int(u) for c_in, _y, _c, _o in cap["steps"]
            for u in c_in.slot_uid[:int(c_in.M)]}
    # a first member's kernel: the program's fit (the reference's own
    # stops elsewhere on the fit's plateau, so it would measure the
    # stopping rule, which no precision below moves: PERF.md)
    born = {int(c_in.uid_next): (c_out.states.theta.outputscale[int(o.slot)],
                                 c_out.states.theta.noise[int(o.slot)])
            for c_in, _y, c_out, o in cap["steps"] if bool(o.birth)}
    if not (live | set(born)) <= set(cap["seed_beats"]):
        return inf
    th = fit_seeds({u: cap["seed_beats"][u] for u in live}, cfg, device)
    th.update(born)
    if control:
        try:
            with precision.tf32():
                th_c = fit_seeds({u: cap["seed_beats"][u]
                                  for u in live | set(born)}, cfg, device,
                                 torch.float32)
        except torch.linalg.LinAlgError:
            return inf
    wrong = 0
    commit = 0.0
    acc = 0.0
    for c_in, y, c_out, o in cap["steps"]:
        r = step(c_in, y.to(device), cfg, th)
        if control:
            try:
                with precision.tf32():
                    g = step(c_in, y.to(device), cfg, th_c, torch.float32)
            except torch.linalg.LinAlgError:
                # a control that breaks down has failed
                return inf
            birth, uid = g["birth"], g["uid"]
            got = {n: g["committed"][n].double() for n in COMMITTED}
            dq, dqlat = g["q_add"], g["qlat_add"]
        else:
            birth, uid = bool(o.birth), int(o.uid)
            got = slot_summary(c_out.states, int(o.slot))
            dq = float(c_out.q_sel_sum) - float(c_in.q_sel_sum)
            dqlat = float(c_out.qlat_sel_sum) - float(c_in.qlat_sel_sum)
        if birth != r["birth"] or uid != r["uid"]:
            wrong += 1
        for name in COMMITTED:
            commit = max(commit, frob_rel(got[name].cpu().numpy(),
                                          r["committed"][name].cpu().numpy()))
        acc = max(acc, rel(dq, r["q_add"]), rel(dqlat, r["qlat_add"]))
    worst = 0.0 if cap["refreshes"] else math.inf
    h = cfg
    for M, sc, tc, g_before, g_after in cap["refreshes"]:
        before = hdp.HDPGlobals(np.asarray(g_before["rho"]),
                                np.asarray(g_before["omega"]),
                                np.asarray(g_before["trans_theta"]),
                                np.asarray(g_before["start_theta"]),
                                h["gamma"], h["trans_alpha"],
                                h["start_alpha"], h["kappa"])
        ref = hdp.engine_refresh(before, sc, tc, M)
        worst = max(worst, 0.0 if control else _glob_rel(g_after, ref))
    return dict(decisions=float(wrong), commit=commit, accounting=acc,
                hdp=worst)
