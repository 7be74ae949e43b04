"""HDP-GPC orchestrator: the offline batch VI sweep (counterpart of
hdpgpc_tpu.models.hdpgpc; reference GPI_HDP, GPI_HDP.py:30-4251).

The accept/reject search over births and reallocations is
data-dependent control flow and runs in Python on the host, as in the
reference; every heavy step runs on the model's device:

* cluster refits: models/gplds.build_refit, batched over up to 4 jobs
  (cluster, lead) per call;
* HMM forward/backward + hard responsibilities: ops/hmm;
* kernel hyperparameter fits: models/kernel_fit (memoised per seed beat);
* HDP stick-breaking (tiny, host numpy): ops/stick_breaking.

``device`` is explicit: "cpu" or "cuda" (which raises without a card).
The offline sweep ``include_batch`` without warp is what this package
runs today; the rest of the reference's surface raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hdpgpc_torch.config import GPConfig, HDPConfig, ModelConfig, WarpConfig
from hdpgpc_torch.data.priors import redefine_default_priors
from hdpgpc_torch.models import gplds
from hdpgpc_torch.models.gplds import ClusterState
from hdpgpc_torch.models.kernel_fit import fit_kernel, fit_kernel_batch
from hdpgpc_torch.ops import hmm as hmm_ops
from hdpgpc_torch.ops import stick_breaking as sb
from hdpgpc_torch.ops.kernels import KernelParams
from hdpgpc_torch.utils.metrics import MetricsLog, SweepMetrics

# process-global kernel-hyperparameter fit memo, content-addressed by
# (x_basis, seed beat, bounds, fit config): the Adam fit is a pure
# deterministic function of these
_GLOBAL_KERNEL_FITS: Dict[tuple, KernelParams] = {}


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to hdpgpc_torch yet "
                              f"(ROADMAP {item})")


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but torch sees no "
                           "CUDA device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Cluster:
    """Host-side handle: cluster state + bookkeeping. ``lds_elbo``
    memoises gplds.lds_param_elbo(state, free_deg); ``state_key`` is the
    refit-memo identity (clusters whose defaults are provably identical
    share it)."""

    __slots__ = ("state", "fitted", "members", "lds_elbo", "uid",
                 "state_key")

    _uid_counter = [0]

    def __init__(self, state: ClusterState, fitted: bool = False,
                 members: Optional[np.ndarray] = None,
                 state_key: Optional[tuple] = None):
        self.state = state
        self.fitted = fitted
        self.members = (np.zeros(0, np.int64) if members is None
                        else np.asarray(members, np.int64))
        self.lds_elbo: Optional[float] = None
        Cluster._uid_counter[0] += 1
        self.uid = Cluster._uid_counter[0]
        self.state_key = state_key if state_key is not None \
            else ("uid", self.uid)

    def clone(self) -> "Cluster":
        c = Cluster(self.state, self.fitted, self.members.copy(),
                    state_key=self.state_key)
        c.lds_elbo = self.lds_elbo
        return c


class HDPGPC:
    """Switching GP-LDS mixture with an HDP prior over the HMM structure.

    Takes a ``ModelConfig`` or the reference-style kwargs
    (GPI_HDP.__init__, GPI_HDP.py:100-174), plus ``device``.
    """

    def __init__(self, x_basis, M: Optional[int] = None, n_outputs: int = 1,
                 x_basis_warp=None, model_type: str = "dynamic",
                 ini_lengthscale: float = 3.0,
                 bound_lengthscale: Tuple[float, float] = (1.0, 20.0),
                 ini_gamma: Optional[float] = None,
                 ini_sigma: Optional[float] = None,
                 ini_outputscale: Optional[float] = None,
                 bound_sigma: Tuple[float, float] = (1e-10, 1e10),
                 bound_gamma: Tuple[float, float] = (1e-1, 1e2),
                 bound_noise_warp: Tuple[float, float] = (1e-10, 1e10),
                 noise_warp: float = 0.05,
                 method_compute_warp: str = "greedy",
                 mode_warp: str = "rough", verbose: bool = False,
                 annealing: bool = True, hmm_switch: bool = True,
                 max_models: Optional[int] = None,
                 bayesian_params: bool = True,
                 inducing_points: bool = False,
                 variational_inducing: bool = False,
                 estimation_limit: Optional[int] = None,
                 reestimate_initial_params: bool = False,
                 n_explore_steps: int = 10, free_deg_MNIV: int = 5,
                 share_gp: bool = False, use_snr: bool = True,
                 reduce_outputs: bool = False,
                 reduce_outputs_ratio: float = 1.0,
                 hdp_hyp: str = "balanced", compute_dtype: str = "float64",
                 config: Optional[ModelConfig] = None, device="cpu",
                 **_ignored):
        if config is None:
            gp_cfg = GPConfig(
                ini_lengthscale=float(ini_lengthscale),
                bound_lengthscale=tuple(bound_lengthscale),
                ini_outputscale=float(ini_outputscale
                                      if ini_outputscale is not None
                                      else (ini_sigma or 1.0)),
                ini_sigma=float(ini_sigma if ini_sigma is not None else 0.25),
                ini_gamma=float(ini_gamma if ini_gamma is not None else 0.01),
                bound_sigma=tuple(bound_sigma),
                bound_gamma=tuple(bound_gamma),
                model_type=model_type, annealing=annealing,
                free_deg_mniw=int(free_deg_MNIV),
                estimation_limit=estimation_limit,
                inducing_points=bool(inducing_points),
                variational_inducing=bool(variational_inducing))
            warp_cfg = WarpConfig(noise_warp=float(noise_warp),
                                  bound_noise_warp=tuple(bound_noise_warp),
                                  mode=mode_warp, method=method_compute_warp)
            config = ModelConfig(
                n_outputs=n_outputs, initial_clusters=M or 1,
                max_models=max_models, hmm_switch=hmm_switch,
                bayesian_params=bayesian_params, use_snr=use_snr,
                reduce_outputs=reduce_outputs,
                reduce_outputs_ratio=reduce_outputs_ratio,
                share_gp=share_gp, n_explore_steps=n_explore_steps,
                reestimate_initial_params=reestimate_initial_params,
                compute_dtype=compute_dtype, hdp=HDPConfig.preset(hdp_hyp),
                gp=gp_cfg, warp=warp_cfg, verbose=verbose)
        if not config.bayesian_params:
            _not_ported("bayesian_params=False (the ML-EM refit)", "A11")
        if config.gp.inducing_points or config.gp.variational_inducing:
            _not_ported("inducing-point kernel fits (SGPR/SVGP)", "A11")
        self.device = resolve_device(device)
        self.cfg = config
        # pre-f32-cap config, for the on_fragile='fallback_f64' re-run
        self._cfg_pre_f32cap = config
        if config.compute_dtype not in ("float32", "float64"):
            raise ValueError(f"compute_dtype {config.compute_dtype!r}")
        self.dtype = torch.float32 if config.compute_dtype == "float32" \
            else torch.float64
        if self.dtype == torch.float32:
            # the speed mode caps the Adam kernel-fit budget
            cap = config.gp.kernel_fit_iters_f32
            if cap and config.gp.kernel_fit_iters > cap:
                config = dataclasses.replace(config, gp=dataclasses.replace(
                    config.gp, kernel_fit_iters=cap))
                self.cfg = config
        self.verbose = config.verbose
        self.n_outputs = config.n_outputs
        self.M = config.initial_clusters
        self.x_basis = np.asarray(x_basis, np.float64).reshape(-1)
        self.Tb = self.x_basis.shape[0]
        self._xb_dev = torch.as_tensor(self.x_basis, dtype=torch.float64,
                                       device=self.device)
        self.x_basis_warp = (self.x_basis if x_basis_warp is None else
                             np.asarray(x_basis_warp, np.float64).reshape(-1))

        # mutable defaults (redefine_default may overwrite; GPI_HDP.py:1866)
        g = config.gp
        self._def_sigma = g.ini_sigma
        self._def_gamma = g.ini_gamma
        self._def_bound_sigma = g.bound_sigma
        self._def_bound_gamma = g.bound_gamma
        self._def_outputscale = g.ini_outputscale
        self._def_lengthscale = g.ini_lengthscale

        self.clusters: List[List[Cluster]] = [
            [self._new_cluster() for _ in range(self.M)]
            for _ in range(self.n_outputs)]
        h = config.hdp
        self.glob = sb.init_globals(self.M, h.gamma, h.trans_alpha,
                                    h.start_alpha, h.kappa)

        self.T_count = 0
        self.train_elbo: List[float] = []
        self.resp_assigned: List[np.ndarray] = []
        self.snr_norm = np.ones((0, self.n_outputs))
        self.f_ind_old = np.zeros(self.M, np.int64)
        self.warp = False
        self._y_scale = 1.0     # f32 speed-mode amplitude normalisation
        # f32 fragility guard: smallest relative decision margin seen by
        # _dec over the current batch sweep
        self.f32_min_rel_margin = float("inf")
        self.f32_fallback: Optional[Dict] = None
        self._kernel_fit_cache = _GLOBAL_KERNEL_FITS
        self._xb_digest = self._digest(self.x_basis)
        self._y_all: Optional[np.ndarray] = None
        self.q_last = None
        self.q_lat_last = None
        self.resp_last = None
        self.respPair_last = None
        self.elbo_last = None
        self.metrics = MetricsLog()
        self._refits: Dict = {}
        # per-include_batch refit memo (see _job_key); [hits, misses]
        self._refit_memo: Dict = {}
        self._memo_stats = [0, 0]
        self._dev_data: Dict = {}

    # ------------------------------------------------------------------
    # cluster construction / refit plumbing
    # ------------------------------------------------------------------

    def _default_theta(self) -> KernelParams:
        """Constant(outputscale) * RBF(lengthscale) + White(bound_sigma[0])
        (GPI_HDP.py:159-166: noise at the LOWER noise bound)."""
        return KernelParams(outputscale=float(self._def_outputscale),
                            lengthscale=float(self._def_lengthscale),
                            noise=float(self._def_bound_sigma[0]))

    def _default_state_key(self) -> tuple:
        return ("def", self._def_sigma, self._def_gamma,
                self._def_outputscale, self._def_lengthscale,
                self._def_bound_sigma)

    def _new_cluster(self) -> Cluster:
        st = gplds.init_cluster_state(
            self._xb_dev, self._default_theta(), self._def_gamma,
            self._def_sigma, float(self.cfg.gp.free_deg_mniw),
            dtype=self.dtype)
        return Cluster(st, fitted=False, state_key=self._default_state_key())

    # a birth-seed job (few members) scans a small bucket of gathered
    # member slots instead of all N
    _SMALL_BUCKET = 256
    # jobs per batched refit call
    _MAX_BATCH = 4

    @staticmethod
    def _bucket_for(n_members: int, N: int) -> Optional[int]:
        b = HDPGPC._SMALL_BUCKET
        return b if n_members <= b < N else None

    def _refit_prog(self, update_params=True, bucket=None):
        key = (update_params, bucket)
        if key not in self._refits:
            self._refits[key] = gplds.build_refit(
                self.Tb, est_limit=self.cfg.gp.estimation_limit,
                annealing=self.cfg.gp.annealing,
                dynamic=self.cfg.gp.model_type == "dynamic",
                update_params=update_params, bucket=bucket,
                free_deg=float(self.cfg.gp.free_deg_mniw))
        return self._refits[key]

    def _fit_key(self, y_seed: np.ndarray) -> tuple:
        g = self.cfg.gp
        return (self._xb_digest, self._digest(np.asarray(y_seed)),
                self._def_bound_sigma, g.kernel_fit_pin_lengthscale,
                g.kernel_fit_iters, g.kernel_fit_lr, str(self.dtype),
                str(self.device))

    def _fit_kw(self) -> dict:
        g = self.cfg.gp
        return dict(pin_lengthscale=g.kernel_fit_pin_lengthscale,
                    max_iters=g.kernel_fit_iters, lr=g.kernel_fit_lr,
                    dtype=self.dtype, device=self.device)

    def _prefetch_kernel_fits(self, jobs) -> None:
        """Run every kernel fit a refit batch needs as ONE batched Adam
        (fit_kernel_batch); results equal the solo fits."""
        need = {}
        for (cl, ld, Y, rc) in jobs:
            if cl.fitted:
                continue
            active = np.flatnonzero(rc > 0.99)
            if active.size == 0:
                continue
            seed = int(active[0])
            key = self._fit_key(Y[seed])
            if key not in self._kernel_fit_cache and key not in need:
                need[key] = Y[seed]
        if len(need) < 2:
            return
        keys = list(need.keys())
        thetas = fit_kernel_batch(self.x_basis,
                                  np.stack([need[k] for k in keys]),
                                  self._def_bound_sigma, **self._fit_kw())
        for k, th in zip(keys, thetas):
            self._kernel_fit_cache[k] = th

    def _maybe_kernel_fit(self, cl: Cluster, ld: int, Y: np.ndarray,
                          resp_col: np.ndarray) -> Cluster:
        """First-active-sample kernel hyperparameter fit
        (GPI_model.py:353-365), memoised by content (_fit_key)."""
        if cl.fitted:
            return cl
        active = np.flatnonzero(resp_col > 0.99)
        if active.size == 0:
            return cl
        seed = int(active[0])
        key = self._fit_key(Y[seed])
        theta = self._kernel_fit_cache.get(key)
        if theta is None:
            theta = fit_kernel(self.x_basis, Y[seed], self._def_bound_sigma,
                               **self._fit_kw())
            self._kernel_fit_cache[key] = theta
            if self.verbose:
                print(f"---Kernel estimated--- lead {ld} seed {seed}: "
                      f"scale={float(theta.outputscale):.4g} "
                      f"noise={float(theta.noise):.4g}")
        st = gplds.apply_kernel_fit(cl.state, self._xb_dev, theta)
        return Cluster(st, fitted=True, members=cl.members,
                       state_key=("fitk", cl.state_key, ld, seed))

    # ------------------------------------------------------------------
    # Refit memoisation: birth/realloc trials within a sweep refit the
    # SAME cluster with the SAME member set repeatedly; a refit is a
    # pure function of (cluster defaults, lead, data, resp column,
    # update_params), cached for one include_batch call.
    # ------------------------------------------------------------------

    @staticmethod
    def _digest(arr: np.ndarray) -> bytes:
        return hashlib.blake2b(np.ascontiguousarray(arr).tobytes(),
                               digest_size=16).digest()

    def _job_key(self, cl: Cluster, ld: int, Y: np.ndarray,
                 resp_col: np.ndarray, update_params: bool):
        return (cl.state_key, cl.fitted, ld, bool(update_params),
                self._digest(resp_col), self._digest(Y))

    _MEMO_CAP = 768

    def _dev_Y(self, Y: np.ndarray) -> torch.Tensor:
        """Device copy of a per-lead data tensor, cached by content (the
        sweep refits over the same (N, T) column many times)."""
        key = self._digest(Y)
        buf = self._dev_data.get(key)
        if buf is None:
            if len(self._dev_data) >= 32:
                self._dev_data.clear()
            buf = torch.as_tensor(np.array(Y), dtype=self.dtype,
                                  device=self.device)
            self._dev_data[key] = buf
        return buf

    def _memo_put(self, key, val):
        if len(self._refit_memo) >= self._MEMO_CAP:
            self._refit_memo.clear()
        self._refit_memo[key] = val

    def _full_refit(self, cl: Cluster, ld: int, Y: np.ndarray,
                    resp_col: np.ndarray, update_params=True):
        return self._full_refit_batch([(cl, ld, Y, resp_col)],
                                      update_params=update_params)[0]

    def _full_refit_batch(self, jobs, update_params=True):
        """Memoised batched refits. jobs: list of (cl, ld, Y (N, T),
        resp_col); returns (q, q_lat, snr, Cluster) per job."""
        if not jobs:
            return []
        keys = [self._job_key(cl, ld, Y, rc, update_params)
                for (cl, ld, Y, rc) in jobs]
        results = [self._refit_memo.get(k) for k in keys]
        miss = [i for i, r in enumerate(results) if r is None]
        self._memo_stats[0] += len(jobs) - len(miss)
        self._memo_stats[1] += len(miss)
        if miss:
            fresh = self._full_refit_batch_raw(
                [jobs[i] for i in miss], update_params=update_params)
            for i, r in zip(miss, fresh):
                self._memo_put(keys[i], r)
                results[i] = r
        return results

    def _full_refit_batch_raw(self, jobs, update_params=True):
        """reinit + kernel fit + batched refit, grouped by scan bucket in
        calls of at most _MAX_BATCH jobs."""
        self._prefetch_kernel_fits(jobs)
        N_all = jobs[0][2].shape[0]
        groups: Dict[Optional[int], list] = {}
        for idx, (cl, ld, Y, rc) in enumerate(jobs):
            b = self._bucket_for(int(np.sum(rc > 0.99)), N_all)
            groups.setdefault(b, []).append(idx)
        results: list = [None] * len(jobs)
        fd = float(self.cfg.gp.free_deg_mniw)
        for bucket, idxs in groups.items():
            for s_ in range(0, len(idxs), self._MAX_BATCH):
                sub_idx = idxs[s_:s_ + self._MAX_BATCH]
                prepped = []
                for i in sub_idx:
                    cl, ld, Y, rc = jobs[i]
                    c2 = Cluster(gplds.reinit_cluster_state(cl.state, fd),
                                 cl.fitted, cl.members,
                                 state_key=cl.state_key)
                    prepped.append(self._maybe_kernel_fit(c2, ld, Y, rc))
                states = gplds.stack_states([c.state for c in prepped])
                Yb = torch.stack([self._dev_Y(jobs[i][2]) for i in sub_idx])
                Rb = torch.as_tensor(np.stack([jobs[i][3] for i in sub_idx]),
                                     dtype=self.dtype, device=self.device)
                res = self._refit_prog(update_params=update_params,
                                       bucket=bucket)(Yb, Rb, states)
                qs, qls, snrs, ldss = (t.cpu().numpy() for t in (
                    res.q, res.q_lat, res.snr, res.lds))
                # use_snr=False: the reference's compute_snr returns ones
                if not self.cfg.use_snr:
                    snrs = np.ones_like(snrs)
                for j, i in enumerate(sub_idx):
                    rc = jobs[i][3]
                    cl_out = Cluster(gplds.index_state(res.state, j),
                                     prepped[j].fitted,
                                     np.flatnonzero(rc > 0.99),
                                     state_key=prepped[j].state_key)
                    cl_out.lds_elbo = float(ldss[j])
                    results[i] = (qs[j], qls[j], snrs[j], cl_out)
        return results

    # ------------------------------------------------------------------
    # SNR fusion (GPI_HDP.py:663-756)
    # ------------------------------------------------------------------

    def compute_snr_ini(self, y_trains: np.ndarray) -> None:
        """Initial per-(beat, lead) SNR vs the mean beat, softmaxed over
        leads (GPI_HDP.compute_snr_ini, GPI_HDP.py:715-730)."""
        N, _, L = y_trains.shape
        if self.cfg.use_snr:
            mean_beat = y_trains.mean(axis=0)
            num = np.sum(mean_beat**2, axis=0)
            den = np.sum((y_trains - mean_beat[None]) ** 2, axis=1)
            snr = 10.0 * (np.log10(np.maximum(num[None, :], 1e-300))
                          - np.log10(np.maximum(den, 1e-300)))
            e = np.exp(snr - snr.max(axis=1, keepdims=True))
            self.snr_norm = e / e.sum(axis=1, keepdims=True)
        else:
            self.snr_norm = np.ones((N, L))

    def normalize_snr(self, snr: np.ndarray) -> np.ndarray:
        """softmax over leads of max-over-clusters (GPI_HDP.py:750-756)."""
        m = snr.max(axis=1)
        e = np.exp(m - m.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def weight_mean(self, q: np.ndarray, snr: Optional[np.ndarray] = None
                    ) -> np.ndarray:
        """SNR-weighted fusion across leads (GPI_HDP.py:685-701), in
        float64 whatever the compute dtype (the birth/realloc accept
        signal is an O(1) difference of O(1e6) sums)."""
        q = np.asarray(q, np.float64)
        if q.ndim > 2:
            w = self.snr_norm if snr is None else self.normalize_snr(snr)
            return np.einsum("ijk,ik->ij", q, w)
        if snr is None:
            frac = self.snr_norm.sum(axis=0) / self.snr_norm.sum()
        else:
            w = self.normalize_snr(snr)
            frac = w.sum(axis=0) / w.sum()
        return np.einsum("ij,j->i", q, frac)

    def reduce_num_outputs(self, y_trains: np.ndarray) -> np.ndarray:
        """Keep the ceil(ratio * L) leads of largest variance of the
        per-beat sums (GPI_HDP.reduce_num_outputs, GPI_HDP.py:703-714)."""
        ratio = self.cfg.reduce_outputs_ratio
        keep = int(np.rint(y_trains.shape[2] * ratio))
        var = np.var(np.sum(y_trains, axis=1), axis=0)
        final = np.sort(var.argsort()[::-1][:keep])
        print("Performed reduction of outputs based on variance.")
        print(f"Ratio of reduction: {ratio} Final outputs: {final}")
        self.n_outputs = keep
        self.clusters = [self.clusters[ld] for ld in final]
        if self.snr_norm.shape[0]:
            self.snr_norm = self.snr_norm[:, final]
        self.cfg = dataclasses.replace(self.cfg, n_outputs=keep)
        return y_trains[:, :, final]

    # ------------------------------------------------------------------
    # HMM message passing wrappers
    # ------------------------------------------------------------------

    def _pis(self, M: int):
        transPi = sb.trans_log_pi_from_theta(self.glob.trans_theta, M,
                                             jitter=1e-5)
        startPi = sb.start_log_pi_from_theta(self.glob.start_theta, M,
                                             jitter=1e-5)
        return startPi, transPi

    def _trans_log_pi_for_K(self, K: int) -> np.ndarray:
        """The reference recomputes the transition matrix inside the
        message passing from the current transTheta at size K
        (compute_trans_A, GPI_HDP.py:3527-3535) with the digamma-of-row-
        sum denominator; a birth candidate's new column gets the stick's
        remainder mass."""
        Mt = self.glob.trans_theta.shape[0]
        Me = min(K, Mt)
        content = sb.trans_log_pi_from_theta(self.glob.trans_theta, Me,
                                             log_sum_exp_form=False)
        if Me == K:
            return content
        tp = np.full((K, K), -np.inf)
        tp[:Me, :Me] = content
        return tp

    def _fb_pack(self, q_w: np.ndarray, startPi):
        """One packed array (row 0: startPi, rows [1, Kp]: transPi, rest:
        evidence), K padded to a multiple of 4 with -inf columns as in
        the reference."""
        K = q_w.shape[1]
        Kp = ((K + 3) // 4) * 4
        fdt = np.float32 if self.dtype == torch.float32 else np.float64
        packed = np.full((q_w.shape[0] + Kp + 1, Kp), -np.inf, fdt)
        spn = np.asarray(startPi)
        packed[0, :min(spn.shape[0], Kp)] = spn[:min(spn.shape[0], Kp)]
        packed[1:K + 1, :K] = self._trans_log_pi_for_K(K)
        packed[Kp + 1:, :K] = q_w
        return packed, K, Kp

    def _fb_hard(self, q_w: np.ndarray, startPi, transPi=None):
        """Hard FB: the device returns the per-row argmax indices and
        the host rebuilds the one-hots (same first-max rule)."""
        packed, K, Kp = self._fb_pack(q_w, startPi)
        idx, pidx = (t.cpu().numpy() for t in hmm_ops.fb_hard_packed_idx(
            torch.as_tensor(packed, device=self.device)))
        N = q_w.shape[0]
        resp = np.zeros((N, K))
        resp[np.arange(N), np.minimum(idx, K - 1)] = 1.0
        respPair = np.zeros((N, K, K))
        respPair[np.arange(N), np.minimum(pidx // Kp, K - 1),
                 np.minimum(pidx % Kp, K - 1)] = 1.0
        return resp, respPair

    # ------------------------------------------------------------------
    # ELBO accounting (GPI_HDP.compute_q_elbo, GPI_HDP.py:1796-1864)
    # ------------------------------------------------------------------

    def _full_lds_elbo(self, clusters_ld: List[Cluster],
                       sum_resp: np.ndarray,
                       one_sample: bool = False) -> float:
        """full_LDS_elbo (GPI_HDP.py:1838-1864); divided by the live
        cluster count only in the offline case, as in the reference."""
        elb = 0.0
        M_ = int(np.sum(sum_resp > 0))
        if M_ == 0:
            return 0.0
        frac = sum_resp / max(sum_resp.sum(), 1e-300)
        live = [i for i, cl in enumerate(clusters_ld)
                if i < sum_resp.shape[0] and sum_resp[i] > 0]
        if not live:
            return 0.0
        todo = [i for i in live if clusters_ld[i].lds_elbo is None]
        if todo:
            states = gplds.stack_states([clusters_ld[i].state for i in todo])
            vals = gplds.lds_param_elbo(
                states, float(self.cfg.gp.free_deg_mniw)).cpu().numpy()
            for j, i in enumerate(todo):
                clusters_ld[i].lds_elbo = float(vals[j])
        for i in live:
            elb += clusters_ld[i].lds_elbo * frac[i]
        return elb if one_sample else elb / M_

    def compute_q_elbo(self, resp, respPair, q_w, q_lat_w, clusters, M,
                       snr="saved", post=False, one_sample=False,
                       verb=None):
        n_points = 1 if one_sample else self.Tb
        sel = resp == 1.0
        q_bas = float(np.sum(np.asarray(q_w[sel], np.float64)))
        elbo_latent = float(np.sum(np.asarray(q_lat_w[sel], np.float64)))
        elbo_lin = sb.elbo_linears(self.glob, resp, respPair, post=post,
                                   one_sample=one_sample) * n_points
        if snr is None:
            frac = np.ones(self.n_outputs) / self.n_outputs
        elif isinstance(snr, str) and snr == "saved":
            f = self.snr_norm.sum(axis=0)
            frac = f / f.sum() * n_points
        else:
            f = self.normalize_snr(snr).sum(axis=0)
            frac = f / f.sum() * n_points
        sum_resp = resp.sum(axis=0)
        elbo_lds = sum(self._full_lds_elbo(clusters[ld], sum_resp,
                                           one_sample=one_sample) * frac[ld]
                       for ld in range(self.n_outputs))
        if verb is None:
            verb = self.verbose
        if verb:
            print("Sum resp_temp: " + str(sum_resp.astype(np.int64))
                  + " - Total: " + str(int(resp.sum())))
            print(f"Q_em: {q_bas:.2f}, Q_lat: {elbo_latent:.2f}, "
                  f"Elbo_linear: {elbo_lin:.2f}, Elbo_LDS: {elbo_lds:.2f}")
        if self.cfg.hmm_switch:
            elbo = elbo_lin + elbo_lds + elbo_latent
        else:
            elbo = elbo_latent
        return q_bas, float(elbo)

    def _dec(self, lhs: float, rhs: float) -> bool:
        """Structural accept/reject comparison, recording the relative
        decision margin for the float32 fragility guard (exact ties are
        not fragile: they mean identical trajectories)."""
        m = abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1.0)
        if 0.0 < m < self.f32_min_rel_margin:
            self.f32_min_rel_margin = m
        return lhs < rhs

    @property
    def f32_fragile(self) -> bool:
        """True when a float32 sweep's narrowest structural decision
        margin sits inside f32 noise: re-run that batch in float64."""
        return (self.dtype == torch.float32
                and self.f32_min_rel_margin < self.cfg.f32_guard_tol)

    def _hdp_global_update(self, resp, respPair, M, n_iters=2,
                           theta_M=None):
        if self.cfg.hmm_switch:
            start_counts = resp[0]
            trans_counts = respPair.sum(axis=0)
        else:
            trans_counts = np.ones((M + 1, M + 1))
            start_counts = np.ones(M + 1)
        self.glob = sb.reinit_globals(self.glob, M, trans_counts,
                                      start_counts)
        tm = (M + 1) if theta_M is None else theta_M
        for _ in range(n_iters):
            tt, st = sb.calc_theta_full(self.glob, trans_counts,
                                        start_counts, tm)
            self.glob = sb.HDPGlobals(self.glob.rho, self.glob.omega, tt, st,
                                      self.glob.gamma, self.glob.trans_alpha,
                                      self.glob.start_alpha, self.glob.kappa)
            self.glob = sb.optimise_globals(self.glob, M=self.M + 1)

    def _warp_by_resp(self, x_trains, y_trains, resp, f_ind_old):
        """Warp off: every cluster sees the raw beats (identity warp,
        GPI_HDP.py:3441). Returns (y_w, x_w, liks)."""
        if self.warp:
            _not_ported("with_warp=True", "A12")
        N, T, L = y_trains.shape
        M = resp.shape[1]
        y_w = np.broadcast_to(y_trains[..., None], (N, T, L, M))
        x_w = np.broadcast_to(x_trains[..., None, None], (N, T, L, M))
        return y_w, x_w, np.zeros((N, M, L))

    # ------------------------------------------------------------------
    # Group bookkeeping (refill / grow / shrink)
    # ------------------------------------------------------------------

    def _refill(self, resp, respPair):
        """Swap an empty column with the last one, or signal sweep end
        (GPI_HDP.refill / refill_resp, GPI_HDP.py:1076-1168)."""
        per_group = resp.sum(axis=0)
        print("Group responsability estimated: "
              + str(per_group.astype(np.int64)), flush=True)
        if np.any(per_group[:-1] < 1.0):
            if per_group[-1] >= 1.0:
                empty = int(np.flatnonzero(per_group < 1.0)[0])
                perm = np.arange(resp.shape[1])
                perm[[empty, -1]] = perm[[-1, empty]]
                resp = resp[:, perm]
                respPair = respPair[:, perm][:, :, perm]
            else:
                print("Empty group detected, new iteration.\n")
                return resp, respPair, True
        return resp, respPair, False

    @staticmethod
    def _grow_cols(resp, respPair, q, q_lat, snr):
        """Append an (empty) cluster column (new_group, GPI_HDP.py:1112)."""
        N, M = resp.shape
        L = q.shape[2]
        resp2 = np.zeros((N, M + 1)); resp2[:, :-1] = resp
        rp2 = np.zeros((N, M + 1, M + 1)); rp2[:, :-1, :-1] = respPair
        q2 = np.zeros((N, M + 1, L)); q2[:, :-1] = q
        ql2 = np.zeros((N, M + 1, L)); ql2[:, :-1] = q_lat
        snr2 = np.zeros((N, M + 1, L))
        snr2 -= np.abs(snr.min(axis=1))[:, None] * 2.0
        snr2[:, :-1] = snr
        return resp2, rp2, q2, ql2, snr2

    @staticmethod
    def _drop_last_col(resp, respPair, q, q_lat, snr):
        return (resp[:, :-1], respPair[:, :-1, :-1], q[:, :-1],
                q_lat[:, :-1], snr[:, :-1])

    def member_indexes(self) -> List[np.ndarray]:
        return [cl.members for cl in self.clusters[0]]

    def selected_gpmodels(self) -> List[int]:
        return [i for i, cl in enumerate(self.clusters[0])
                if cl.members.size > 0]

    # ------------------------------------------------------------------
    # Offline batch VI (GPI_HDP.include_batch, GPI_HDP.py:805-947)
    # ------------------------------------------------------------------

    def include_batch(self, x_trains, y_trains, it_limit: Optional[int] = None,
                      with_warp: bool = False):
        """Run the offline variational sweep over a batch of beats.

        x_trains: (N, T) or (N, T, 1) time grids (shared grid assumed);
        y_trains: (N, T, L).
        """
        if with_warp:
            _not_ported("with_warp=True", "A12")
        self.warp = False
        y = np.asarray(y_trains, np.float64)
        if y.ndim == 2:
            y = y[:, :, None]
        x = np.asarray(x_trains, np.float64)
        x = x.reshape(x.shape[0], -1) if x.ndim > 1 else x
        N, T, L = y.shape
        assert T == self.Tb and L == self.n_outputs
        if self.cfg.reduce_outputs and self.cfg.reduce_outputs_ratio < 1.0:
            y = self.reduce_num_outputs(y)          # GPI_HDP.py:830-831
            L = self.n_outputs
        if self.dtype == torch.float32:
            y = self._maybe_normalise_f32(y)
        self._refit_memo.clear()
        self._memo_stats = [0, 0]
        self.f32_min_rel_margin = float("inf")
        h = self.cfg.hdp
        print("------ HDP Hyperparameters ------", flush=True)
        print("gamma: " + str(h.gamma))
        print("transAlpha: " + str(h.trans_alpha))
        print("startAlpha: " + str(h.start_alpha))
        print("kappa: " + str(h.kappa))
        print("---------------------------------", flush=True)
        self.T_count += N
        self._y_all = y
        self._x_grid = x[0] if x.ndim > 1 else self.x_basis
        self.compute_snr_ini(y)
        if self.cfg.reestimate_initial_params:
            self._redefine_default(y)

        M = self.M
        resp = np.zeros((N, M)); resp[:, 0] = 1.0
        respPair = np.zeros((N, M, M)); respPair[:, 0, 0] = 1.0
        q = np.zeros((N, M, L))
        q_lat = np.zeros((N, M, L))
        snr = np.zeros((N, M, L))
        y_w = np.broadcast_to(y[..., None], (N, T, L, M))
        iteration = 0
        reallocate = False
        t_sweep = time.time()
        while True:
            resp, respPair, end = self._refill(resp, respPair)
            M = self.M
            if resp.shape[1] == 1:
                self._hdp_global_update(resp, respPair, M, n_iters=2)
            if end:
                break
            (resp, respPair, q, q_lat, snr, y_w,
             reallocate) = self._vlt_batch(M, x, y, y_w, resp, respPair,
                                           q, q_lat, snr, reallocate)
            if resp.shape[1] > M:
                self.M = M + 1
                M = self.M
            elif resp.shape[1] < M:
                # Emergency group removal shrank the bank mid-sweep
                # (GPI_HDP.py:1451-1460 trims gpmodels but never resyncs
                # self.M — a latent reference crash in _calcThetaFull on
                # the next global update). Resync to the live count.
                self.M = resp.shape[1]
                M = self.M
            self._hdp_global_update(resp, respPair, M, n_iters=2)
            if self.T_count > 1:
                elbo_ = float(hmm_ops.entropy_terms(
                    torch.as_tensor(resp, dtype=self.dtype,
                                    device=self.device),
                    torch.as_tensor(respPair, dtype=self.dtype,
                                    device=self.device)))
                print(f"\n-------End Lower Bound Iteration {iteration}-------")
                q_obs, elbo_lin = self.compute_q_elbo(
                    resp, respPair, self.weight_mean(q),
                    self.weight_mean(q_lat), self.clusters, self.M,
                    snr="saved", post=False, verb=True)
                elbo_ = elbo_ + elbo_lin + q_obs
                print("ELBO + Nonlinear: " + str(elbo_))
                self.metrics.append(**SweepMetrics(
                    iteration=iteration, elbo=float(elbo_),
                    q_obs=float(q_obs), elbo_linear=float(elbo_lin),
                    n_clusters=self.M,
                    resp_counts=resp.sum(axis=0).astype(int).tolist(),
                    seconds=time.time() - t_sweep).to_dict())
                t_sweep = time.time()
                iteration += 1
                print(f"\n-------Start lower Bound Iteration {iteration}-------")
                self.train_elbo.append(elbo_)
                self.resp_assigned.append(np.argmax(resp, axis=1))
                self.q_last, self.q_lat_last = q, q_lat
                self.resp_last, self.respPair_last = resp, respPair
                self.elbo_last = elbo_
                if it_limit is not None and iteration >= it_limit:
                    break
                if self.M == self.cfg.max_models:
                    break
                resp_group = resp.sum(axis=0)
                repeated = (len(self.resp_assigned) > 1
                            and self.resp_assigned[-2].shape[0]
                            == self.resp_assigned[-1].shape[0]
                            and np.all(self.resp_assigned[-2]
                                       == self.resp_assigned[-1]))
                if np.flatnonzero(resp_group == 0.0).shape[0] > 1 or repeated:
                    break
            else:
                break
        if self.f32_fragile:
            msg = (f"float32 speed mode is dtype-FRAGILE on this "
                   f"batch (narrowest decision margin "
                   f"{self.f32_min_rel_margin:.2e} < "
                   f"{self.cfg.f32_guard_tol:.0e} rel): the clustering may "
                   "not match the f64 exact mode — re-run this record with "
                   "compute_dtype='float64'.")
            action = getattr(self.cfg, "on_fragile", "warn")
            if action == "raise":
                raise FloatingPointError(
                    msg + " (config.on_fragile='raise'; set 'fallback_f64'"
                    " to re-run automatically)")
            if action == "fallback_f64" and self.T_count == N:
                self._run_f64_fallback(x_trains, y_trains, it_limit,
                                       with_warp)
                return self
            if action == "fallback_f64":
                # model already holds earlier batches a fresh f64 re-run
                # would lose — degrade to the warning
                msg += (" (fallback_f64 skipped: model holds "
                        f"{self.T_count - N} earlier beats)")
            print("WARNING: " + msg, flush=True)
        return self

    def _run_f64_fallback(self, x_trains, y_trains, it_limit, with_warp):
        """on_fragile='fallback_f64': re-run this batch in float64 exact
        mode on a fresh model and adopt its state, keeping the f32
        telemetry on ``self.f32_fallback``. Mirrors the reference's
        failure-fallback idiom (OptimizerRhoOmega.py:59-95: retry ladder
        ending in a safe re-init) at the dtype level."""
        _dc = dataclasses
        frag_margin = self.f32_min_rel_margin
        print(f"WARNING: f32 fragility guard fired (margin "
              f"{frag_margin:.2e} < {self.cfg.f32_guard_tol:.0e} rel); "
              "on_fragile='fallback_f64' — re-running this batch in "
              "float64 exact mode.", flush=True)
        # derive from the LIVE config (callers may have tuned it after
        # construction), undoing only the ctor's f32 kernel-fit cap
        iters = self.cfg.gp.kernel_fit_iters
        pre = self._cfg_pre_f32cap.gp.kernel_fit_iters
        cap = self.cfg.gp.kernel_fit_iters_f32
        if cap and iters == cap and pre > cap:
            iters = pre
        cfg64 = _dc.replace(
            self.cfg, compute_dtype="float64", on_fragile="warn",
            gp=_dc.replace(self.cfg.gp, kernel_fit_iters=iters))
        fb = HDPGPC(self.x_basis, x_basis_warp=self.x_basis_warp,
                    config=cfg64, device=self.device)
        fb.include_batch(x_trains, y_trains, it_limit=it_limit,
                         with_warp=with_warp)
        self.__dict__.update(fb.__dict__)
        self.f32_fallback = {"min_rel_margin": float(frag_margin),
                             "from_dtype": "float32"}

    def _maybe_normalise_f32(self, y: np.ndarray) -> np.ndarray:
        """float32 speed mode: raw MIT-BIH amplitudes reach ~1e3, and
        squared residuals at ~1e6 exhaust f32 mantissa in the Cholesky
        chains — on large-amplitude records every birth gets rejected
        (rec 119: M=1/err 23% unscaled vs M=9/err 0 normalised).
        Normalise internally and rescale the variance-like priors by
        s^2; scores shift by a constant per beat, which cancels in
        every accept/reject comparison at fixed cluster count. Used by
        both the offline sweep and the online streaming engine."""
        if self._y_scale != 1.0:
            return y / self._y_scale
        s = float(np.std(y))
        if not (s > 8.0 or s < 0.125):
            return y
        print(f"float32 speed mode: normalising amplitudes "
              f"(scale {s:.4g}).")
        self._y_scale = s
        y = y / s
        sc = s * s
        self._def_sigma /= sc
        self._def_gamma /= sc
        self._def_outputscale /= sc
        self._def_bound_sigma = tuple(
            b / sc for b in self._def_bound_sigma)
        self._def_bound_gamma = tuple(
            b / sc for b in self._def_bound_gamma)
        for ld_ in range(self.n_outputs):
            for m_ in range(len(self.clusters[ld_])):
                self.clusters[ld_][m_] = self._new_cluster()
        return y

    def _redefine_default(self, y: np.ndarray) -> None:
        """Re-estimate Sigma/Gamma priors from the batch and rebuild
        default clusters (GPI_HDP.redefine_default, GPI_HDP.py:1866-1904)."""
        print("Redefining default LDS priors.")
        s, g, bs, bg = redefine_default_priors(
            y, self.cfg.gp.estimation_limit)
        # The estimator reads the first 10 samples per series (an ECG
        # pre-QRS-baseline assumption, GPI_HDP.py:1876-1880). On data
        # that is ~0 there (e.g. spectra), it returns 0 and would
        # install singular covariance priors; keep the constructor's.
        if not (np.isfinite(s) and np.isfinite(g) and s > 0 and g > 0):
            print("Reestimated priors degenerate "
                  f"(sigma={s}, gamma={g}); keeping constructor priors.")
            return
        self._def_sigma, self._def_gamma = s, g
        self._def_bound_sigma, self._def_bound_gamma = bs, bg
        self._refit_memo.clear()
        print("-----------Reestimated ------------", flush=True)
        print("Sigma: ", s)
        print("Gamma: ", g)
        print("-----------------------------", flush=True)
        for ld in range(self.n_outputs):
            for m in range(len(self.clusters[ld])):
                self.clusters[ld][m] = self._new_cluster()

    def _vlt_batch(self, M, x, y, y_w, resp, respPair, q, q_lat, snr,
                   reallocate):
        """variational_local_terms_batch (GPI_HDP.py:1170-1241)."""
        startPi, transPi = self._pis(M)
        i = 0
        per_group = resp.sum(axis=0)
        first_cond = (per_group.shape[0] == 1 or per_group[-2] >= 1.0
                      or not self.clusters[0][0].fitted)
        if first_cond:
            (resp, respPair, q, q_lat, snr, y_w,
             reallocate) = self._estimate_q_first(
                M, x, y, y_w, resp, respPair, q, q_lat, snr,
                startPi, transPi, reallocate)
            post = resp.shape[1] > self.M
            q_bas, elbo_bas = self.compute_q_elbo(
                resp, respPair, self.weight_mean(q), self.weight_mean(q_lat),
                self.clusters, self.M, snr="saved", post=post)
            i += 1
            print("First resp: " + str(resp.sum(axis=0).astype(np.int64)))
        else:
            q_bas, elbo_bas = self.compute_q_elbo(
                resp, respPair, self.weight_mean(q), self.weight_mean(q_lat),
                self.clusters, self.M, snr="saved", post=False)
            print("Not first estimated q.")
        q_def, elbo_def = q_bas, elbo_bas
        if not reallocate:
            while True:
                M = resp.shape[1]
                (resp, respPair, q, q_lat, snr, y_w,
                 accepted_clusters) = self._estimate_q_all(
                    M, x, y, y_w, resp, respPair, q, q_lat, snr,
                    startPi, transPi, q_def, elbo_def)
                self.clusters = accepted_clusters
                post = resp.shape[1] > self.M
                q_post, elbo_post = self.compute_q_elbo(
                    resp, respPair, self.weight_mean(q),
                    self.weight_mean(q_lat), self.clusters, self.M,
                    snr="saved", post=post)
                print("ELBO_reduction: "
                      + str((q_post + elbo_post) - (q_bas + elbo_bas)))
                if (np.isclose(q_bas + elbo_bas, q_post + elbo_post,
                               rtol=1e-5) and i > 0) or i == 10:
                    break
                q_bas, elbo_bas = q_post, elbo_post
                i += 1
        return resp, respPair, q, q_lat, snr, y_w, reallocate

    # ------------------------------------------------------------------
    # estimate_q_all (GPI_HDP.py:2844-2973)
    # ------------------------------------------------------------------

    def _estimate_q_all(self, M, x, y, y_w_, resp, respPair, q_, q_lat_,
                        snr_, startPi, transPi, q_def, elbo_def,
                        clusters=None, f_ind_old=None, post=True):
        if clusters is None:
            clusters = self.clusters
        if f_ind_old is None:
            f_ind_old = self.f_ind_old
        N, _, L = y.shape
        q = np.zeros((N, M, L)) + np.min(q_) * 2.0
        q_lat = np.zeros((N, M, L))
        snr_aux = snr_.copy()

        q_norm = self.weight_mean(q_, snr_)
        q_norm = q_norm - q_norm.max(axis=1, keepdims=True)
        resp_temp, respPair_temp = self._fb_hard(q_norm, startPi, transPi)
        per_group = resp_temp.sum(axis=0)
        reorder = np.argsort(-per_group, kind="stable")
        resp_temp = resp_temp[:, reorder].copy()

        y_w, x_w, liks = self._warp_by_resp(x, y, resp_temp, f_ind_old)

        clusters_temp: List[List[Cluster]] = [
            [None] * M for _ in range(L)]
        jobs = []
        job_slots = []
        for ld in range(L):
            for m in range(M):
                idx_new = np.flatnonzero(resp_temp[:, m] == 1.0)
                if reorder[m] < len(clusters[ld]):
                    cl = clusters[ld][reorder[m]]
                    if not np.array_equal(idx_new, cl.members):
                        jobs.append((cl, ld, y_w[:, :, ld, reorder[m]],
                                     resp_temp[:, m]))
                        job_slots.append((ld, m))
                    else:
                        q[:, m, ld] = q_[:, reorder[m], ld]
                        q_lat[:, m, ld] = q_lat_[:, reorder[m], ld]
                        snr_aux[:, m, ld] = snr_[:, m, ld]
                        clusters_temp[ld][m] = cl
                else:
                    cl = self._new_cluster()
                    if idx_new.size > 0:
                        jobs.append((cl, ld, y_w[:, :, ld, reorder[m]],
                                     resp_temp[:, m]))
                        job_slots.append((ld, m))
                    else:
                        q[:, m, ld] = q_[:, m, ld]
                        q_lat[:, m, ld] = q_lat_[:, m, ld]
                        snr_aux[:, m, ld] = 0.0
                        clusters_temp[ld][m] = cl
        for (ld, m), (q_col, ql_col, s_col, cl2) in zip(
                job_slots, self._full_refit_batch(jobs)):
            q[:, m, ld] = q_col + liks[:, reorder[m], ld]
            q_lat[:, m, ld] = ql_col
            snr_aux[:, m, ld] = s_col
            clusters_temp[ld][m] = cl2

        print(">>> Q_all_loop -------")
        q_bas, elbo_bas = self.compute_q_elbo(
            resp, respPair, self.weight_mean(q_, snr_),
            self.weight_mean(q_lat_, snr_), clusters, self.M, snr=snr_,
            post=post)
        q_post, elbo_post = self.compute_q_elbo(
            resp_temp, respPair_temp, self.weight_mean(q, snr_aux),
            self.weight_mean(q_lat, snr_aux), clusters_temp, M, snr=snr_aux,
            post=post)
        if np.all(resp_temp.sum(axis=0) >= 1.0):
            if self._dec(q_bas + elbo_bas, q_post + elbo_post):
                y_w = y_w[:, :, :, reorder]
                if reorder.shape[0] == self.f_ind_old.shape[0]:
                    self.f_ind_old = self.f_ind_old[reorder]
                self.snr_norm = self.normalize_snr(snr_aux)
                return (resp_temp, respPair_temp, q, q_lat, snr_aux, y_w,
                        clusters_temp)
            return resp, respPair, q_, q_lat_, snr_, y_w_, clusters
        print(f">>> Possible emergency reallocation. Prev ----:\n "
              f"Q_em: {q_def}, Elbo: {elbo_def}")
        if (self._dec(q_def + elbo_def, q_post + elbo_post)
                and self._dec(q_bas + elbo_bas, q_post + elbo_post)):
            print("Emergency reallocation and removing last group.")
            for ld in range(L):
                clusters_temp[ld] = clusters_temp[ld][:-1]
            self.snr_norm = self.normalize_snr(snr_aux)
            resp_temp, respPair_temp, q, q_lat, snr_aux = \
                self._drop_last_col(resp_temp, respPair_temp, q, q_lat,
                                    snr_aux)
            pg = resp_temp.sum(axis=0)
            ro = np.argsort(-pg, kind="stable")
            if ro.shape[0] == self.f_ind_old.shape[0]:
                self.f_ind_old = self.f_ind_old[ro]
            return (resp_temp, respPair_temp, q, q_lat, snr_aux, y_w,
                    clusters_temp)
        print("Bad estimation")
        return resp, respPair, q_, q_lat_, snr_, y_w, clusters

    # ------------------------------------------------------------------
    # estimate_q_first: reallocation + birth search (GPI_HDP.py:1243-1794)
    # ------------------------------------------------------------------

    def _seed_score(self, cl: Cluster, ld: int, Y: np.ndarray,
                    seed: int):
        """q_simple column: reinit, include ONE representative beat with
        no Bayesian update, score all beats (GPI_HDP.py:1284-1297).
        Memoised alongside the refits (birth trials re-score the same
        (cluster, seed) pair repeatedly)."""
        key = ("seed", cl.state_key, cl.fitted, ld, int(seed),
               self._digest(Y))
        hit = self._refit_memo.get(key)
        if hit is not None:
            self._memo_stats[0] += 1
            return hit
        self._memo_stats[1] += 1
        st = gplds.reinit_cluster_state(cl.state,
                                        float(self.cfg.gp.free_deg_mniw))
        resp_seed = np.zeros(Y.shape[0]); resp_seed[seed] = 1.0
        prog = self._refit_prog(update_params=False,
                                bucket=self._bucket_for(1, Y.shape[0]))
        res = prog(self._dev_Y(Y),
                   torch.as_tensor(resp_seed, dtype=self.dtype,
                                   device=self.device), st)
        out = (res.q.cpu().numpy(), res.snr.cpu().numpy())
        self._memo_put(key, out)
        return out

    @staticmethod
    def _normalized_rank(v: np.ndarray) -> np.ndarray:
        return (v - v.max()) / (v.max() - v.min() + 1e-300)

    def _estimate_q_first(self, M, x, y, y_w_, resp, respPair, q_, q_lat_,
                          snr_, startPi, transPi, reallocate_):
        N, T, L = y.shape
        empty_estimation = False
        y_w, x_w, liks = self._warp_by_resp(x, y, resp, self.f_ind_old)

        # ---- cold init: build cluster 0 from the full batch ----
        if np.mean(q_) == 0.0:
            snr_ = np.zeros((N, M, L))
            for ld in range(L):
                cl = self._new_cluster()
                q_col, ql_col, s_col, cl = self._full_refit(
                    cl, ld, y_w[:, :, ld, 0], resp[:, 0])
                q_[:, 0, ld] = q_col + liks[:, 0, ld]
                q_lat_[:, 0, ld] = ql_col
                snr_[:, 0, ld] = s_col
                self.clusters[ld][0] = cl
        reallocate = False

        # member sets (fall back to resp columns for empty clusters)
        indexes_ = []
        for m in range(M):
            idx = self.clusters[0][m].members
            if idx.size == 0:
                idx = np.flatnonzero(resp[:, m] == 1.0)
            indexes_.append(idx)
        f_ind_old = self.f_ind_old.copy()

        # ---- q_simple: score each cluster seeded with its representative
        # (batched across all (lead, cluster) pairs in one vmapped call)
        q_simple = q_.copy()
        seed_jobs, seed_slots = [], []
        for ld in range(L):
            for m in range(M):
                if indexes_[m].size > 0:
                    rc = np.zeros(N)
                    rc[int(f_ind_old[m])] = 1.0
                    cl = self.clusters[ld][m]
                    st = gplds.reinit_cluster_state(
                        cl.state, float(self.cfg.gp.free_deg_mniw))
                    seed_jobs.append((Cluster(st, cl.fitted, cl.members,
                                              state_key=cl.state_key),
                                      ld, y_w[:, :, ld, m], rc))
                    seed_slots.append((ld, m))
        for (ld, m), (qs, _ql, _snr, _cl) in zip(
                seed_slots,
                self._full_refit_batch(seed_jobs, update_params=False)):
            q_simple[:, m, ld] = qs + liks[:, m, ld]

        snr_aux = snr_.copy()
        if M > 1:
            # ---- reallocation trial ----
            q_aux = q_simple.copy()
            if resp.sum(axis=0)[-1] == 0:
                q_aux[:, -1, :] = np.min(q_aux) * 2.0
                snr_aux[:, -1, :] = np.min(snr_aux) * 2.0
            q_norm = self.weight_mean(q_aux, snr_aux)
            q_norm = q_norm - q_norm.max(axis=1, keepdims=True)
            resp_temp, respPair_temp = self._fb_hard(q_norm, startPi, transPi)
            reorder = np.argsort(-resp_temp.sum(axis=0), kind="stable")
            resp_temp = resp_temp[:, reorder].copy()

            q = q_.copy()
            q_lat = q_lat_.copy()
            clusters_temp: List[List[Cluster]] = [
                [None] * M for _ in range(L)]
            jobs, slots = [], []
            for ld in range(L):
                for m in range(M):
                    if not np.array_equal(resp[:, reorder[m]],
                                          resp_temp[:, m]):
                        jobs.append((self.clusters[ld][reorder[m]], ld,
                                     y_w[:, :, ld, reorder[m]],
                                     resp_temp[:, m]))
                        slots.append((ld, m))
                    else:
                        cl = self.clusters[ld][reorder[m]]
                        q[:, m, ld] = q_[:, reorder[m], ld]
                        snr_aux[:, m, ld] = snr_[:, reorder[m], ld]
                        clusters_temp[ld][m] = cl
            for (ld, m), (q_col, ql_col, s_col, cl2) in zip(
                    slots, self._full_refit_batch(jobs)):
                q[:, m, ld] = q_col + liks[:, reorder[m], ld]
                q_lat[:, m, ld] = ql_col
                snr_aux[:, m, ld] = s_col
                clusters_temp[ld][m] = cl2

            q_bas_, elbo_bas_ = self.compute_q_elbo(
                resp_temp, respPair_temp, self.weight_mean(q, snr_aux),
                self.weight_mean(q_lat, snr_aux), clusters_temp, M,
                snr=snr_aux, post=False)
            q_def__, elbo_def__ = self.compute_q_elbo(
                resp, respPair, self.weight_mean(q_, snr_),
                self.weight_mean(q_lat_, snr_), self.clusters, M,
                snr=snr_, post=False)
            i__ = 0
            while True:
                (resp_temp, respPair_temp, q, q_lat, snr_aux, y_w,
                 clusters_temp) = self._estimate_q_all(
                    M, x, y, y_w, resp_temp, respPair_temp, q, q_lat,
                    snr_aux, startPi, transPi, q_def__, elbo_def__,
                    clusters=clusters_temp, post=False)
                q_post, elbo_post = self.compute_q_elbo(
                    resp_temp, respPair_temp, self.weight_mean(q, snr_aux),
                    self.weight_mean(q_lat, snr_aux), clusters_temp, M,
                    snr=snr_aux, post=False)
                print("ELBO_reduction: "
                      + str((q_post + elbo_post) - (q_bas_ + elbo_bas_)))
                if (np.isclose(q_bas_ + elbo_bas_, q_post + elbo_post,
                               rtol=1e-5) and i__ > 0) or i__ == 20:
                    break
                q_bas_, elbo_bas_ = q_post, elbo_post
                i__ += 1

            print(">>> Prev -------")
            q_bas, elbo_bas = self.compute_q_elbo(
                resp, respPair, self.weight_mean(q_, snr_),
                self.weight_mean(q_lat_, snr_), self.clusters, M,
                snr=snr_, post=False)
            print(">>> Post -------")
            q_bas_post, elbo_post = self.compute_q_elbo(
                resp_temp, respPair_temp, self.weight_mean(q, snr_aux),
                self.weight_mean(q_lat, snr_aux), clusters_temp, M,
                snr=snr_aux, post=False)
            if np.flatnonzero(resp_temp.sum(axis=0) < 1.0).shape[0] == 0:
                if (q_bas < q_bas_post
                        and not q_bas + elbo_bas < q_bas_post + elbo_post):
                    print("Possibly better q_obs but worse elbo.")
                if (self._dec(q_bas + elbo_bas, q_bas_post + elbo_post)
                        and q_bas != q_bas_post):
                    print("Reallocating beats into existing groups.")
                    reallocate = True
                    self.clusters = clusters_temp
                    y_w = y_w[:, :, :, reorder] if y_w.shape[3] == M else y_w
                    self.f_ind_old = self._elect_representatives(
                        resp_temp, self.weight_mean(q_simple, snr_aux),
                        f_ind_old)
                    self.snr_norm = self.normalize_snr(snr_aux)
                    return (resp_temp, respPair_temp, q, q_lat, snr_aux,
                            y_w, reallocate)
                print("Not reallocating, trying to generate new group.")
            else:
                print(">>> Possible emergency reallocation. Prev ----")
                q_bas, elbo_bas = self.compute_q_elbo(
                    resp, respPair, self.weight_mean(q_, snr_),
                    self.weight_mean(q_lat_, snr_), self.clusters, self.M,
                    snr=snr_, post=False)
                if self._dec(q_bas + elbo_bas, q_bas_ + elbo_bas_):
                    print("Emergency reallocation and removing last group.")
                    reallocate = True
                    for ld in range(L):
                        clusters_temp[ld] = clusters_temp[ld][:-1]
                    self.clusters = clusters_temp
                    self.snr_norm = self.normalize_snr(snr_aux)
                    resp_temp, respPair_temp, q, q_lat, snr_aux = \
                        self._drop_last_col(resp_temp, respPair_temp, q,
                                            q_lat, snr_aux)
                    ro = np.argsort(-resp_temp.sum(axis=0), kind="stable")
                    self.f_ind_old = self.f_ind_old[
                        ro[:self.f_ind_old.shape[0]]] \
                        if ro.shape[0] >= self.f_ind_old.shape[0] \
                        else self.f_ind_old
                    return (resp_temp, respPair_temp, q, q_lat, snr_aux,
                            y_w, reallocate)
                print("Bad estimation")
                empty_estimation = True

        # ---- birth candidate ranking (GPI_HDP.py:1461-1529) ----
        assigned = np.flatnonzero(resp.sum(axis=1) >= 1.0)
        q_sim_s = self._normalized_rank(
            self.weight_mean(q_simple)[resp == 1.0])
        q_s = self._normalized_rank(self.weight_mean(q_)[resp == 1.0])
        q_lat_s = self._normalized_rank(self.weight_mean(q_lat_)[resp == 1.0])
        order_by_sim = np.argsort(q_sim_s, kind="stable")
        order_by_q = np.argsort(q_s + q_lat_s, kind="stable")
        # closeness groups at rtol=0.01 on the q_simple rank
        n_steps = self.cfg.n_explore_steps
        potential_ind = {int(i): np.flatnonzero(
            np.isclose(q_sim_s, q_sim_s[i], rtol=0.01))
            for i in range(q_sim_s.shape[0])}

        def pick_candidates(order, start_j, stop_j, picked, last_holder):
            j_ = start_j
            for f_ind_new in order:
                if j_ == stop_j:
                    break
                f_ind_new = int(f_ind_new)
                m_chosen = -1
                for m in range(M - 1):
                    if f_ind_new in indexes_[m]:
                        m_chosen = m
                        break
                if m_chosen == -1:
                    m_chosen = int(np.argmax(resp[f_ind_new]))
                if f_ind_new == int(f_ind_old[min(m_chosen,
                                                  f_ind_old.shape[0] - 1)]):
                    continue
                group = potential_ind[f_ind_new]
                if any(l_ not in group for l_ in last_holder[0]):
                    last_holder[0] = group
                    picked[j_] = f_ind_new
                    j_ += 1
            return j_

        candidates = np.zeros(n_steps, np.int64)
        last_holder = [np.array([-1])]
        half = int(max(n_steps // 2, 1))
        pick_candidates(order_by_sim, 0, half, candidates, last_holder)
        last_holder = [np.array([-1])]
        pick_candidates(order_by_q, half, n_steps, candidates, last_holder)

        # ---- birth trials (GPI_HDP.py:1530-1793) ----
        q = q_simple.copy()
        q_lat = q_lat_.copy()
        snr_aux = snr_.copy()
        resp_g, respPair_g, q_def, q_lat_def, snr_def = self._grow_cols(
            resp, respPair, q.copy(), q_lat.copy(), snr_aux.copy())
        _, _, q__def, q_lat__def, snr__def = self._grow_cols(
            resp, respPair, q_.copy(), q_lat_.copy(), snr_.copy())
        Mb = M + 1
        f_ind_grow = np.zeros(Mb, np.int64)
        f_ind_grow[:f_ind_old.shape[0]] = f_ind_old

        step = 0
        last_indexes = np.array([-1])
        for f_ind_new in candidates:
            if step == n_steps:
                break
            f_ind_new = int(f_ind_new)
            m_chosen = -1
            for m in range(Mb - 1):
                if m < len(indexes_) and f_ind_new in indexes_[m]:
                    m_chosen = m
                    break
            if m_chosen == -1:
                m_chosen = int(np.argmax(resp[f_ind_new]))
            if f_ind_new == int(f_ind_grow[min(m_chosen, Mb - 1)]):
                continue
            group = potential_ind.get(f_ind_new, np.array([f_ind_new]))
            if not any(l_ not in group for l_ in last_indexes):
                continue
            last_indexes = group

            if not empty_estimation:
                f_ind_temp = f_ind_grow.copy()
                f_ind_temp[-1] = f_ind_new
                y_w, x_w, liks = self._warp_by_resp(x, y, resp_g, f_ind_temp)
                q_simple_ = q_def.copy()
                q = q_def.copy(); q_lat = q_lat_def.copy()
                snr_aux = snr_def.copy()
                q__ = q__def.copy(); q_lat__ = q_lat__def.copy()
                print(f"Step {step + 1}/{n_steps}- Trying to divide: "
                      f"{m_chosen} with beat {f_ind_new}")
                step += 1
                for ld in range(L):
                    qs, s_col = self._seed_score(
                        self.clusters[ld][m_chosen], ld,
                        y_w[:, :, ld, -1], f_ind_new)
                    q_simple_[:, -1, ld] = qs + liks[:, -1, ld]
                    snr_aux[:, -1, ld] = s_col
                q_mean = self.weight_mean(q_simple_, snr_aux)
                q_norm = q_mean - q_mean.max(axis=1, keepdims=True)
                resp_temp, respPair_temp = self._fb_hard(q_norm, startPi,
                                                         transPi)
            else:
                q = q__def.copy(); q_lat = q_lat__def.copy()
                snr_aux = snr__def.copy()
                q__ = q__def.copy(); q_lat__ = q_lat__def.copy()
                q[:, -1, :] = np.min(q) * 2.0
                q__[:, -1, :] = np.min(q__) * 2.0
                snr_aux[:, -1, :] = np.min(snr_aux) * 2.0
                q__[f_ind_new, -1, :] = 0.0
                q_simple_ = q__.copy()
                f_ind_temp = f_ind_grow.copy(); f_ind_temp[-1] = f_ind_new
                step += 1
                q_mean = self.weight_mean(q__, snr_aux)
                q_norm = q_mean - q_mean.max(axis=1, keepdims=True)
                resp_temp, respPair_temp = self._fb_hard(q_norm, startPi,
                                                         transPi)

            reorder = np.argsort(-resp_temp.sum(axis=0), kind="stable")
            resp_temp = resp_temp[:, reorder].copy()

            clusters_temp: List[List[Cluster]] = [
                [None] * Mb for _ in range(L)]
            jobs, slots = [], []
            # the empty_estimation branch reuses the PREVIOUS y_w (M
            # columns) while indexing Mb = M + 1 slots; warp columns are
            # identical when warp is off (and keyed by representative
            # otherwise), so clamp to the last available column
            ywc = y_w.shape[3] - 1
            for ld in range(L):
                for m in range(Mb):
                    if reorder[m] == Mb - 1:
                        # the newborn cluster
                        if self.cfg.share_gp:
                            cl = self.clusters[ld][m_chosen].clone()
                        else:
                            cl = self._new_cluster()
                        jobs.append((cl, ld,
                                     y_w[:, :, ld, min(reorder[m], ywc)],
                                     resp_temp[:, m]))
                        slots.append((ld, m))
                    elif not np.array_equal(resp[:, reorder[m]],
                                            resp_temp[:, m]):
                        jobs.append((self.clusters[ld][reorder[m]], ld,
                                     y_w[:, :, ld, min(reorder[m], ywc)],
                                     resp_temp[:, m]))
                        slots.append((ld, m))
                    else:
                        cl = self.clusters[ld][reorder[m]]
                        q[:, m, ld] = q__[:, reorder[m], ld]
                        q_lat[:, m, ld] = q_lat__[:, reorder[m], ld]
                        snr_aux[:, m, ld] = snr__def[:, reorder[m], ld]
                        clusters_temp[ld][m] = cl
            lkc = liks.shape[1] - 1
            for (ld, m), (q_col, ql_col, s_col, cl2) in zip(
                    slots, self._full_refit_batch(jobs)):
                q[:, m, ld] = q_col + liks[:, min(reorder[m], lkc), ld]
                q_lat[:, m, ld] = ql_col
                snr_aux[:, m, ld] = s_col
                clusters_temp[ld][m] = cl2

            q_bas_, elbo_bas_ = self.compute_q_elbo(
                resp_temp, respPair_temp, self.weight_mean(q, snr_aux),
                self.weight_mean(q_lat, snr_aux), clusters_temp, Mb,
                snr=snr_aux, post=True)
            sums = resp_temp.sum(axis=0)
            if int(np.argmax(sums)) == resp_temp.shape[1] - 1:
                print("Bad estimation")
                continue
            if np.flatnonzero(sums < 1.0).shape[0] > 0:
                print(">>> Possible emergency reallocation. Prev ----")
                q_bas, elbo_bas = self.compute_q_elbo(
                    resp, respPair, self.weight_mean(q_, snr_),
                    self.weight_mean(q_lat_, snr_), self.clusters, self.M,
                    snr=snr_, post=False)
                if self._dec(q_bas + elbo_bas, q_bas_ + elbo_bas_):
                    print("Emergency reallocation and removing last group.")
                    reallocate = True
                    for ld in range(L):
                        clusters_temp[ld] = clusters_temp[ld][:-1]
                    resp_temp, respPair_temp, q, q_lat, snr_aux = \
                        self._drop_last_col(resp_temp, respPair_temp, q,
                                            q_lat, snr_aux)
                    self.clusters = clusters_temp
                    self.f_ind_old = f_ind_grow[reorder][:resp_temp.shape[1]]
                    y_w = y_w[:, :, :, reorder][:, :, :, :resp_temp.shape[1]]
                    self.snr_norm = self.normalize_snr(snr_aux)
                    return (resp_temp, respPair_temp, q, q_lat, snr_aux,
                            y_w, reallocate)
                print("Bad estimation")
                continue

            q_def__, elbo_def__ = self.compute_q_elbo(
                resp, respPair, self.weight_mean(q_, snr_),
                self.weight_mean(q_lat_, snr_), self.clusters, self.M,
                snr=snr_, post=False)
            i__ = 0
            while True:
                (resp_temp, respPair_temp, q, q_lat, snr_aux, y_w,
                 clusters_temp) = self._estimate_q_all(
                    Mb, x, y, y_w, resp_temp, respPair_temp, q, q_lat,
                    snr_aux, startPi, transPi, q_def__, elbo_def__,
                    clusters=clusters_temp, f_ind_old=f_ind_temp)
                q_post, elbo_post = self.compute_q_elbo(
                    resp_temp, respPair_temp, self.weight_mean(q, snr_aux),
                    self.weight_mean(q_lat, snr_aux), clusters_temp, Mb,
                    snr=snr_aux, post=True)
                print("ELBO_reduction: "
                      + str((q_post + elbo_post) - (q_bas_ + elbo_bas_)))
                if (np.isclose(q_bas_ + elbo_bas_, q_post + elbo_post,
                               rtol=1e-5) and i__ > 0) or i__ == 10:
                    break
                q_bas_, elbo_bas_ = q_post, elbo_post
                i__ += 1

            print(f"- Trying to divide: {m_chosen} with beat {f_ind_new}")
            print(">>> Prev -------")
            q_bas, elbo_bas = self.compute_q_elbo(
                resp, respPair, self.weight_mean(q_, snr_),
                self.weight_mean(q_lat_, snr_), self.clusters, self.M,
                snr=snr_, post=False)
            print(">>> Post -------")
            q_bas_post, elbo_post = self.compute_q_elbo(
                resp_temp, respPair_temp, self.weight_mean(q, snr_aux),
                self.weight_mean(q_lat, snr_aux), clusters_temp, Mb,
                snr=snr_aux, post=True)
            sums = resp_temp.sum(axis=0)
            if (np.all(sums >= 1.0)
                    and int(np.argmax(sums)) != resp_temp.shape[1] - 1):
                if (q_bas < q_bas_post
                        and not q_bas + elbo_bas < q_bas_post + elbo_post):
                    print("Possibly better q_obs but worse elbo.")
                if self._dec(q_bas + elbo_bas, q_bas_post + elbo_post):
                    print(f"Chosen to divide: {m_chosen} with beat "
                          f"{f_ind_new}")
                    self.clusters = clusters_temp
                    if y_w.shape[3] == Mb:
                        y_w = y_w[:, :, :, reorder]
                    self.f_ind_old = self._elect_representatives(
                        resp_temp, self.weight_mean(q_simple_, snr_aux),
                        f_ind_grow)
                    self.snr_norm = self.normalize_snr(snr_aux)
                    return (resp_temp, respPair_temp, q, q_lat, snr_aux,
                            y_w, reallocate)
            else:
                print("Bad estimation")

        reallocate = True
        return resp, respPair, q_, q_lat_, snr_, y_w_, reallocate

    def _elect_representatives(self, resp_temp, q_rank, f_ind_old
                               ) -> np.ndarray:
        """Re-elect one representative beat per cluster, best q first,
        without reuse (GPI_HDP.py:1404-1429, :1760-1785)."""
        Mk = resp_temp.shape[1]
        out = np.full(Mk, -1, np.int64)
        used = set()
        for k in range(Mk):
            idx_k = np.flatnonzero(resp_temp[:, k] == 1.0)
            if idx_k.size == 0:
                out[k] = f_ind_old[min(k, f_ind_old.shape[0] - 1)]
                continue
            order = np.argsort(-q_rank[idx_k, k], kind="stable")
            cand = None
            for i in idx_k[order]:
                if int(i) not in used:
                    cand = int(i)
                    break
            if cand is None:
                cand = int(idx_k[order[0]])
            out[k] = cand
            used.add(cand)
        return out
    # ------------------------------------------------------------------
    # The reference's surface beyond the offline sweep
    # ------------------------------------------------------------------

    def include_sample(self, *args, **kwargs):
        _not_ported("include_sample (online streaming VI)", "A9")

    def include_sample_fast(self, *args, **kwargs):
        _not_ported("include_sample_fast (online streaming VI)", "A9")

    def cluster_new_batch(self, *args, **kwargs):
        _not_ported("cluster_new_batch (frozen-cluster classifier)", "A13")

    def reload_model_from_labels(self, *args, **kwargs):
        _not_ported("reload_model_from_labels", "A13")

    def save_swgp(self, *args, **kwargs):
        _not_ported("save_swgp (checkpoints)", "A13")

    @classmethod
    def load_swgp(cls, *args, **kwargs):
        _not_ported("load_swgp (checkpoints)", "A13")
