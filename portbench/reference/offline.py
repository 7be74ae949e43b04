"""The offline sweep's comparison: the program's state at the close of
its last completed sweep, worked out again in float64.

From the beats and the program's partition (its hard responsibilities)
the reference fits each cluster's kernel on the beat that seeded it (the
program's choice of beat, its fit done again), refits every cluster
from scratch (the priors from the beats, the float32 mode's amplitude
rule), re-runs the HDP global update and the sweep's ELBO, and re-runs
the hard forward-backward on the program's own inputs of that sweep.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.frozen.priors import compute_estimators_lds
from portbench.reference import gplds as G
from portbench.reference import hdp
from portbench.reference import hmm
from portbench.reference import kernel_fit
from portbench.reference import precision


def rel(a, b, floor=1.0) -> float:
    """max |a - b| / max(|b|, floor), elementwise."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    d = np.abs(a - b) / np.maximum(np.abs(b), floor)
    return float(np.max(np.where(np.isfinite(d), d, np.inf)))


def frob_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    v = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))
    return v if np.isfinite(v) else float("inf")


def model_priors(y: np.ndarray, cfg: Dict) -> Dict:
    """The model's priors and the amplitude rule of the float32 mode
    (beats scaled to unit spread when their spread is above 8 or below
    1/8, the variance priors by its square)."""
    std, std_dif, bs, _bg = compute_estimators_lds(y)
    y = np.asarray(y, np.float64)
    scale = 1.0
    if cfg["compute_dtype"] == "float32":
        s = float(np.std(y))
        if s > 8.0 or s < 0.125:
            scale = s
    sc = scale * scale
    return dict(y=y / scale, sigma=std / sc, gamma=std_dif / sc,
                bound_sigma=(bs[0] / sc, bs[1] / sc))


def reference_outputs(cap: Dict, cfg: Dict, device,
                      dtype=torch.float64) -> Dict:
    """The reference's own outputs for the program's partition: each
    cluster's kernel fitted on its seed beat, its refit (scores, latent
    scores, final A, Gamma, C, Sigma), the HDP globals (host float64)
    and the sweep's ELBO; in ``dtype``."""
    pri = model_priors(cap["y"], cfg)
    y = torch.as_tensor(pri["y"][:, :, 0], dtype=dtype, device=device)
    N, T = y.shape
    x = torch.arange(T, dtype=dtype, device=device)
    resp = np.asarray(cap["resp"], np.float64)
    respPair = np.asarray(cap["respPair"], np.float64)
    M = resp.shape[1]
    seeds = [seed_index(pri["y"][:, :, 0], cl["seed_beat"])
             for cl in cap["clusters"]]
    if min(seeds, default=0) < 0:
        return {}
    os_r, nz_r = kernel_fit.fit(x, y[torch.as_tensor(seeds, device=device)],
                                pri["bound_sigma"][0], pri["bound_sigma"][1],
                                cfg["fit_iters"], cfg["fit_lr"])
    q = np.zeros((N, M))
    q_lat = np.zeros((N, M))
    states, lds = [], np.zeros(M)
    I = torch.eye(T, dtype=dtype, device=device)
    c0s = [G.fresh_cluster(x, os_r[k], cfg["pin_lengthscale"], nz_r[k],
                           pri["gamma"], pri["sigma"], cfg["free_deg_MNIV"])
           for k in range(M)]
    members = [torch.as_tensor(resp[:, k] == 1.0, device=device)
               for k in range(M)]
    for k, r in enumerate(G.refit(c0s, y, members,
                                  cfg["estimation_limit"])):
        q[:, k] = r["q"].double().cpu().numpy()
        q_lat[:, k] = r["q_lat"].double().cpu().numpy()
        states.append({n: r[n].double().cpu().numpy()
                       for n in ("A", "Gamma", "C", "Sigma")})
        lds[k] = float(G.lds_param_elbo(r["A"], r["Gamma"], r["C"],
                                        r["Sigma"], pri["gamma"] * I,
                                        pri["sigma"] * I))
    h = cfg["hdp"]
    glob = hdp.global_update(resp, respPair, M, h["gamma"],
                             h["trans_alpha"], h["start_alpha"], h["kappa"])
    sel = resp == 1.0
    sum_resp = resp.sum(axis=0)
    live = sum_resp > 0
    frac = sum_resp / max(sum_resp.sum(), 1e-300)
    elbo_lds = float(np.sum(lds[live] * frac[live])) / max(int(live.sum()),
                                                           1) * T
    elbo = (hmm.entropy_terms(resp, respPair)
            + hdp.elbo_linears(glob, resp, respPair) * T + elbo_lds
            + float(np.sum(q_lat[sel])) + float(np.sum(q[sel])))
    return dict(q=q, q_lat=q_lat, states=states, elbo=elbo,
                glob=dict(rho=glob.rho, omega=glob.omega,
                          trans_theta=glob.trans_theta,
                          start_theta=glob.start_theta))


def check(cap: Dict, cfg: Dict, device, control: bool = False
          ) -> Dict[str, float]:
    """``cap``: beats ``y`` (N, T, 1) as generated; the program's ``resp``
    (N, M), ``respPair`` (N, M, M), scores ``q`` and ``q_lat`` (N, M),
    ``clusters`` (per cluster: A, Gamma, C, Sigma and the beat its
    kernel fit was seeded by), HDP globals ``glob`` (rho, omega,
    trans_theta, start_theta), ``elbo``, and its forward-backward calls
    of the sweep ``fb`` [(packed, idx, pair_idx)]. Returns each compared
    number; ``fb_rows`` reads inf when no call was captured. With
    ``control`` the reference in float32 with TF32 products stands in
    the program's place (its forward-backward in float32)."""
    ref = reference_outputs(cap, cfg, device)
    if not ref:
        return {}
    if control:
        with precision.tf32():
            got = reference_outputs(cap, cfg, device, torch.float32)
        fb = [(p, *hmm.fb_hard_idx(p, np.float32)) for p, _i, _q in cap["fb"]]
    else:
        got = dict(q=cap["q"], q_lat=cap["q_lat"], elbo=cap["elbo"],
                   glob=cap["glob"], states=cap["clusters"])
        fb = cap["fb"]
    out: Dict[str, float] = {}
    out["refit_q"] = rel(got["q"], ref["q"])
    out["refit_q_lat"] = rel(got["q_lat"], ref["q_lat"])
    out["refit_state"] = max(
        frob_rel(a[n], b[n]) for a, b in zip(got["states"], ref["states"])
        for n in ("A", "Gamma", "C", "Sigma"))
    out["hdp"] = max(rel(got["glob"][n], ref["glob"][n], 1e-300)
                     for n in ("rho", "omega", "trans_theta", "start_theta"))
    out["elbo"] = rel(got["elbo"], ref["elbo"])
    worst = 0 if fb else math.inf
    for packed, idx, pidx in fb:
        r_idx, r_pidx = hmm.fb_hard_idx(packed)
        worst = max(worst, int(np.sum((np.asarray(idx) != r_idx)
                                      | (np.asarray(pidx) != r_pidx))))
    out["fb_rows"] = float(worst)
    return out


def seed_index(y: np.ndarray, beat: np.ndarray) -> int:
    """The index of the beat that seeded a cluster's kernel fit; -1 when
    the program fitted no beat for it, or one that is not among the
    beats (every number then reads as failed)."""
    if beat is None:
        return -1
    hit = np.flatnonzero(np.all(y == np.asarray(beat)[None], axis=1))
    return int(hit[0]) if hit.size else -1
