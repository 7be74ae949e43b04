"""HDP-GPC orchestrator (counterpart of hdpgpc_tpu.models.hdpgpc;
reference GPI_HDP, GPI_HDP.py:30-4251): the offline batch VI sweep and
the two host-driven online steps.

The accept/reject search over births and reallocations is
data-dependent control flow and runs in Python on the host, as in the
reference; every heavy step runs on the model's device:

* cluster refits: models/gplds.build_refit, batched over up to 4 jobs
  (cluster, lead) per call offline, over every absorb candidate of a
  beat online;
* HMM forward/backward + hard responsibilities: ops/hmm;
* kernel hyperparameter fits: models/kernel_fit (memoised per seed beat);
* HDP stick-breaking (tiny, host numpy): ops/stick_breaking;
* monotone warps: warp/monotone.py, a fixed-count Adam on the device,
  in float64 whatever the compute dtype (as in the reference);
* the ML-EM refit (bayesian_params=False): models/ml_em.py on the
  smoothed moments of a refit.

``device`` defaults to "cuda" and raises without a card; "cpu" runs the
kernels' plain versions.
This package runs the offline sweep ``include_batch``, the online steps
``include_sample`` and ``include_sample_fast`` (each with or without
the warp, Bayesian or ML-EM), the post-hoc ``compute_warp_actual_state``,
the supervised path (``reload_model_from_labels``, ``cluster_new_batch``)
and the npz checkpoints (``save_swgp``, ``load_swgp``, the format of
hdpgpc_tpu), with exact or inducing-point (SGPR / SVGP) kernel fits;
models/stream_online.py holds the fused stream engine (warp off,
Bayesian) and models/streaming.py the frozen-cluster classifier.
hdpgpc_tpu's legacy round-1 pickle checkpoints are not read (they hold
JAX arrays and hdpgpc_tpu classes).

With ``HDPGPC_TIMING=1`` in the environment a model times its phases
(``timings``, ``counts``, ``print_timings``; see ``_install_timers``);
``warmup_programs(N)`` runs the refit lattice once up front.

While the recorder of utils/metrics is on (``metrics.enable()``), the
offline sweep records spans: a ``sweep.refill`` each pass of
``include_batch``'s loop, then, unless the refill ends the loop, a
``sweep`` closed at its SweepMetrics record (a batch of one beat stops
before its ELBO and records none) around ``sweep.first`` (with
``first.cold_init``, ``first.q_simple``, ``first.realloc_trial``,
``first.birth_rank`` and a ``first.birth_trial`` a candidate tried),
``sweep.q_all`` and ``sweep.elbo``; a ``refit[J]`` a batched refit
program call of J jobs; and the timed phases under their timer keys.
Its counters: ``refit.jobs`` (jobs that reach the refit program past
the memo), ``birth.trials`` and ``birth.accepted``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hdpgpc_torch import convert
from hdpgpc_torch.config import GPConfig, HDPConfig, ModelConfig, WarpConfig
from hdpgpc_torch.data.priors import redefine_default_priors
from hdpgpc_torch.device import DEFAULT_DEVICE, resolve_device
from hdpgpc_torch.models import gplds, ml_em
from hdpgpc_torch.models.gplds import ClusterState
from hdpgpc_torch.models.kernel_fit import (fit_kernel, fit_kernel_batch,
                                            fit_kernel_sgpr, fit_kernel_svgp)
from hdpgpc_torch.models.streaming import emission_scores
from hdpgpc_torch.ops import _build
from hdpgpc_torch.ops import hmm as hmm_ops
from hdpgpc_torch.ops import linalg
from hdpgpc_torch.ops import stick_breaking as sb
from hdpgpc_torch.ops.kernels import KernelParams
from hdpgpc_torch.utils.metrics import MetricsLog, SweepMetrics, count, span
from hdpgpc_torch.warp.monotone import (build_batch_warp, make_warp_prior,
                                        warp_prior_score)

# process-global kernel-hyperparameter fit memo, content-addressed by
# (x_basis, seed beat, bounds, fit config): the Adam fit is a pure
# deterministic function of these
_GLOBAL_KERNEL_FITS: Dict[tuple, KernelParams] = {}


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
    (GPI_HDP.__init__, GPI_HDP.py:100-174), plus ``device`` and
    ``kernel_fit_iters`` (the kernel fits' Adam budget, GPConfig's
    default when None).
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
                 kernel_fit_iters: Optional[int] = None,
                 config: Optional[ModelConfig] = None,
                 device=DEFAULT_DEVICE,
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
            if kernel_fit_iters is not None:
                gp_cfg = dataclasses.replace(
                    gp_cfg, kernel_fit_iters=int(kernel_fit_iters))
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
        # phase timing (HDPGPC_TIMING=1; _install_timers): seconds and
        # calls by phase, and the phases open now
        self._timing_on = os.environ.get("HDPGPC_TIMING") == "1"
        self.timings: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._timing_stack: List[list] = []
        self._refits: Dict = {}
        # per-include_batch refit memo (see _job_key); [hits, misses]
        self._refit_memo: Dict = {}
        self._memo_stats = [0, 0]
        self._dev_data: Dict = {}
        # per-lead stacked cluster states of the online fast path
        self._stack_cache: Dict[int, Tuple[tuple, ClusterState]] = {}
        # batch warps keyed by (lead, representative beat); the warp
        # optimisers (batch and online iteration counts) and priors
        self._warp_cache: Dict = {}
        self._warp_fn_batch = None
        self._warp_fn_online = None
        self._warp_priors: Dict = {}
        # warps run (batch: one per (lead, representative) cache miss,
        # online: one per beat and cluster) and batch-cache hits
        self.warp_counts = {"batch": 0, "batch_hits": 0, "online": 0}

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

    def _refit_prog(self, update_params=True, pair_smooth=True,
                    full_backward=True, bucket=None):
        key = (update_params, pair_smooth, full_backward, bucket)
        if key not in self._refits:
            self._refits[key] = gplds.build_refit(
                self.Tb, est_limit=self.cfg.gp.estimation_limit,
                annealing=self.cfg.gp.annealing,
                dynamic=self.cfg.gp.model_type == "dynamic",
                update_params=update_params, pair_smooth=pair_smooth,
                full_backward=full_backward, bucket=bucket,
                free_deg=float(self.cfg.gp.free_deg_mniw))
        return self._refits[key]

    def warmup_programs(self, N: int) -> None:
        """Build both kernel libraries (on a card) and run the refit
        lattice for data length N once (bucket x batch width x
        update_params, as hdpgpc_tpu compiles it), on zero beats and a
        cluster marked fitted (no kernel fit), so that a timed sweep
        pays no nvcc build and no first call of a cuBLAS or cuSOLVER
        routine. Memos, counters and timings are left as they were."""
        if self.device.type == "cuda":
            _build.load()
        dummy_Y = np.zeros((N, self.Tb))
        base = self._new_cluster()
        base = Cluster(base.state, fitted=True, state_key=base.state_key)
        for update_params in (True, False):
            widths = [1] if N <= self._SMALL_BUCKET else [1, 2,
                                                          self._MAX_BATCH]
            for B in widths:
                for n_mem in (1, self._SMALL_BUCKET + 1):
                    if n_mem > N:
                        continue
                    rc = np.zeros(N)
                    rc[:n_mem] = 1.0
                    self._full_refit_batch_raw(
                        [(base, 0, dummy_Y, rc)] * B,
                        update_params=update_params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def print_timings(self):
        tot = sum(self.timings.values())
        for k in sorted(self.timings, key=lambda k: -self.timings[k]):
            print(f"  [time] {k}: {self.timings[k]:.1f}s x{self.counts[k]}")
        print(f"  [time] total tracked: {tot:.1f}s")
        print(f"  [memo] refit hits/misses: {self._memo_stats[0]}/"
              f"{self._memo_stats[1]}")

    def _fit_theta(self, y: np.ndarray) -> KernelParams:
        """Kernel hyperparameter fit on one beat: the exact-GP Adam fit
        (GPI.fit_torch exact path) or, with cfg.gp.inducing_points, the
        SGPR (or, with variational_inducing, SVGP) fit with learnable
        inducing locations and no lengthscale pin (GPI.py:641-770)."""
        g = self.cfg.gp
        if g.variational_inducing and not g.inducing_points:
            raise ValueError(
                "variational_inducing=True requires inducing_points=True "
                "(the SVGP fit is the variational member of the "
                "inducing-point family, GPI_models_pytorch.py:37-46)")
        if not g.inducing_points:
            return fit_kernel(self.x_basis, y, self._def_bound_sigma,
                              **self._fit_kw())
        fit_ind = fit_kernel_svgp if g.variational_inducing \
            else fit_kernel_sgpr
        theta, _Z = fit_ind(self.x_basis, y, self._def_bound_sigma,
                            max_iters=g.kernel_fit_iters_inducing,
                            lr=g.kernel_fit_lr, dtype=self.dtype,
                            device=self.device)
        return theta

    def _fit_key(self, y_seed: np.ndarray) -> tuple:
        """Content-addressed memo key of a kernel fit: the fit is a pure
        function of (x_basis, seed beat, bounds, fit config)."""
        g = self.cfg.gp
        return (self._xb_digest, self._digest(np.asarray(y_seed)),
                self._def_bound_sigma, g.kernel_fit_pin_lengthscale,
                g.kernel_fit_iters, g.kernel_fit_iters_inducing,
                g.kernel_fit_lr, str(self.dtype), g.inducing_points,
                g.variational_inducing, str(self.device))

    def _fit_kw(self) -> dict:
        g = self.cfg.gp
        return dict(pin_lengthscale=g.kernel_fit_pin_lengthscale,
                    max_iters=g.kernel_fit_iters, lr=g.kernel_fit_lr,
                    dtype=self.dtype, device=self.device)

    def _prefetch_kernel_fits(self, jobs) -> None:
        """Run every kernel fit a refit batch needs as ONE batched Adam
        (fit_kernel_batch); results equal the solo fits. The inducing
        fits stay solo."""
        if self.cfg.gp.inducing_points:
            return
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
            theta = self._fit_theta(Y[seed])
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
        calls of at most _MAX_BATCH jobs. With bayesian_params=False a
        parameter-updating refit is the ML-EM refit, one job at a time
        (each runs its own host-level EM loop)."""
        if update_params and not self.cfg.bayesian_params:
            return [self._full_refit_ml(cl, ld, Y, rc)
                    for (cl, ld, Y, rc) in jobs]
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
                # one span a batched program call, named by its jobs:
                # inputs stacked, the program, its scores read back
                count("refit.jobs", len(sub_idx))
                with span("refit", len(sub_idx)):
                    states = gplds.stack_states([c.state for c in prepped])
                    Yb = torch.stack([self._dev_Y(jobs[i][2])
                                      for i in sub_idx])
                    Rb = torch.as_tensor(
                        np.stack([jobs[i][3] for i in sub_idx]),
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

    def _refit_prog_ml(self, bucket=None):
        """Scoring program of the ML-EM path: fixed-parameter filter +
        RTS + scores, emitting the smoothed member sequences the EM
        M-step consumes (GPI.new_params_LDS, GPI.py:302-455)."""
        key = ("ml", bucket)
        if key not in self._refits:
            self._refits[key] = gplds.build_refit(
                self.Tb, est_limit=self.cfg.gp.estimation_limit,
                annealing=self.cfg.gp.annealing,
                dynamic=self.cfg.gp.model_type == "dynamic",
                update_params=False, pair_smooth=True, full_backward=True,
                bucket=bucket, emit_smoothed=True)
        return self._refits[key]

    def _full_refit_ml(self, cl: Cluster, ld: int, Y: np.ndarray,
                       resp_col: np.ndarray):
        """ML-EM refit (bayesian_params=False): filter/smooth under the
        current LDS params, run the masked EM on the smoothed member
        moments (GPI_model.new_params, GPI_model.py:747-861), then
        rescore under the fitted params. As in hdpgpc_tpu, the EM runs
        once over the full member set rather than at the reference's
        per-sample cadence inside the sweep.

        Returns (q, q_lat, snr, Cluster)."""
        st = gplds.reinit_cluster_state(cl.state,
                                        float(self.cfg.gp.free_deg_mniw))
        cl2 = Cluster(st, cl.fitted, cl.members, state_key=cl.state_key)
        cl2 = self._maybe_kernel_fit(cl2, ld, Y, resp_col)
        members = np.flatnonzero(resp_col > 0.99)
        prog = self._refit_prog_ml(
            bucket=self._bucket_for(members.size, Y.shape[0]))
        Yj = self._dev_Y(Y)
        rj = self._dev(resp_col)
        res, (Y_s, f_sm, P_sm, m_s) = prog(Yj, rj, cl2.state)
        st2 = cl2.state
        if members.size >= 2 and self.cfg.gp.model_type == "dynamic":
            A, G, C, S = ml_em.ml_update_masked(
                st2.A, st2.Gamma, st2.C, st2.Sigma, Y_s[..., None],
                f_sm, P_sm, m_s)
            st2 = st2._replace(A=A, Gamma=G, C=C, Sigma=S)
            res, _ = prog(Yj, rj, st2)
        out = Cluster(res.state, cl2.fitted, members,
                      state_key=cl2.state_key)
        snr = res.snr.cpu().numpy() if self.cfg.use_snr \
            else np.ones(Y.shape[0])
        return res.q.cpu().numpy(), res.q_lat.cpu().numpy(), snr, out

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

    def compute_joint_xy_q(self, y_trains: np.ndarray,
                           outputs: Tuple[int, int] = (0, 1),
                           rho_xy: Optional[np.ndarray] = None,
                           jitter: float = 1e-6) -> np.ndarray:
        """Joint two-lead Gaussian emission score with a per-cluster
        cross-lead correlation (GPI_HDP.compute_joint_xy_q,
        GPI_HDP.py:758-803), in float64. The reference reads a
        ``self.rho_xy`` that nothing initialises; here the correlations
        are an argument (default: uncorrelated). The joint (2T, 2T)
        covariance does not depend on the beat, so it is factored once
        per cluster and the N residuals are solved together."""
        ld_x, ld_y = outputs
        N, T, _ = y_trains.shape
        M = len(self.clusters[ld_x])
        rho = np.tanh(np.zeros(M) if rho_xy is None
                      else np.asarray(rho_xy, np.float64))
        q = np.zeros((N, M))
        for m in range(M):
            means, covs = [], []
            for ld in (ld_x, ld_y):
                st = self.clusters[ld][m].state
                means.append((st.C @ st.f_last).cpu().numpy().reshape(-1))
                covs.append(st.Sigma.cpu().numpy().astype(np.float64))
            sx = np.sqrt(np.clip(np.diag(covs[0]), jitter, None))
            sy = np.sqrt(np.clip(np.diag(covs[1]), jitter, None))
            cross = rho[m] * np.diag(sx * sy)
            Sig = np.block([[covs[0], cross], [cross.T, covs[1]]]) \
                + jitter * np.eye(2 * T)
            r = np.concatenate([
                y_trains[:, :, ld_x] - means[0][None],
                y_trains[:, :, ld_y] - means[1][None]], axis=1)  # (N, 2T)
            L_ = linalg.chol(self._f64(Sig))
            alpha = linalg.cho_solve(L_, self._f64(r.T)).cpu().numpy()
            logdet = float(2.0 * torch.sum(torch.log(torch.diagonal(L_))))
            q[:, m] = -0.5 * (np.einsum("ij,ji->i", r, alpha) + logdet
                              + 2 * T * np.log(2.0 * np.pi))
        return q

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

    # ------------------------------------------------------------------
    # Warp orchestration (identity when the warp is off, GPI_HDP.py:3441)
    # ------------------------------------------------------------------

    def _f64(self, a) -> torch.Tensor:
        """A host array as a float64 tensor on the model's device: the
        warp runs in float64 in both compute dtypes."""
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=self.device)

    def _warp_prior(self):
        T = self.Tb
        prior = self._warp_priors.get(T)
        if prior is None:
            w = self.cfg.warp
            prior = make_warp_prior(self._xb_dev, w.noise_warp,
                                    w.bound_noise_warp)
            self._warp_priors[T] = prior
        return prior

    def _build_warp(self, train_iter: int):
        w = self.cfg.warp
        return build_batch_warp(self.Tb, n_ctrl=w.n_ctrl, lr=w.lr,
                                lam_s_base=w.lambda_smooth,
                                lam_a_base=w.lambda_amp,
                                train_iter=train_iter)

    def _warp_by_resp(self, x_trains, y_trains, resp, f_ind_old):
        """Batched warp keyed by representative beats, cached per
        (lead, ref-beat) (warp_batch_by_resp_amtgp_cached,
        GPI_HDP.py:3412-3517): one warp of all N beats per (lead,
        representative) against that beat, ``train_iter_batch`` Adam
        steps. The noise is mean(diag Sigma) of the cluster, clamped into
        bound_noise_warp (amtgp:611-617 via GPI_HDP.py:3383-3384).

        Returns (y_w, x_w, liks): y_w (N, T, L, M) warped per cluster,
        liks (N, M, L) (the warp's prior score counted twice, as in
        hdpgpc_tpu: ``lik`` plus a fresh ``warp_prior_score``)."""
        N, T, L = y_trains.shape
        M = resp.shape[1]
        if not self.warp:
            y_w = np.broadcast_to(y_trains[..., None], (N, T, L, M))
            x_w = np.broadcast_to(x_trains[..., None, None], (N, T, L, M))
            return y_w, x_w, np.zeros((N, M, L))

        if self._warp_fn_batch is None:
            self._warp_fn_batch = self._build_warp(
                self.cfg.warp.train_iter_batch)
        prior = self._warp_prior()
        y_w = np.empty((N, T, L, M))
        x_w = np.empty((N, T, L, M))
        liks = np.zeros((N, M, L))
        lo, hi = self.cfg.warp.bound_noise_warp
        for ld in range(L):
            for m in range(M):
                ref = int(f_ind_old[min(m, f_ind_old.shape[0] - 1)])
                key = (ld, ref)
                if key in self._warp_cache:
                    xw, yw, lk = self._warp_cache[key]
                    self.warp_counts["batch_hits"] += 1
                else:
                    self.warp_counts["batch"] += 1
                    cl = self.clusters[ld][min(m, len(self.clusters[ld]) - 1)]
                    n = float(np.clip(float(np.mean(np.diag(
                        cl.state.Sigma.cpu().numpy()))), lo, hi))
                    res = self._warp_fn_batch(
                        self._xb_dev, self._f64(y_trains[:, :, ld]),
                        self._f64(y_trains[ref, :, ld]), prior, 1.0, 1.0, n)
                    lk = res.lik + warp_prior_score(prior, res.x_warp)
                    xw, yw, lk = (a.cpu().numpy()
                                  for a in (res.x_warp, res.y_warp, lk))
                    self._warp_cache[key] = (xw, yw, lk)
                y_w[:, :, ld, m] = yw
                x_w[:, :, ld, m] = xw
                liks[:, m, ld] = lk
        return y_w, x_w, liks

    def reset_warp_cache(self):
        self._warp_cache = {}

    def _warp_setup(self):
        """The online warp optimiser (``train_iter_online`` Adam steps)
        and the prior."""
        if self._warp_fn_online is None:
            self._warp_fn_online = self._build_warp(
                self.cfg.warp.train_iter_online)
        return self._warp_prior()

    def _online_warp_inputs(self, cl: Cluster):
        """The template C f_last (computed in the model dtype, then
        float64) and the noise Sigma[0, 0] clamped into bound_noise_warp
        (_safe_noise, amtgp:44-57) of one cluster."""
        mean = (cl.state.C @ cl.state.f_last)[:, 0].to(torch.float64)
        lo, hi = self.cfg.warp.bound_noise_warp
        n = float(np.clip(float(cl.state.Sigma[0, 0]), lo, hi))
        return mean, n

    def _warp_one(self, y_ld, ld, m, prior):
        """Warp one beat against cluster m; returns (y_w, x_w, lik)
        (compute_warp inner call, GPI_HDP.py:3215-3224).

        Reference semantics pinned here:
        * the data-term noise is diag(cov)[0] CLAMPED into
          bound_noise_warp (_safe_noise, amtgp:44-57);
        * theta passed upstream is a scalar lengthscale, so the
          theta->lambda mapping never fires (amtgp:380) — base lambdas
          apply (rho = omega = 1);
        * lik = MAP data log-lik of the warped beat under the template +
          GP-prior score of the warp (GPI_HDP.py:3300)."""
        mean, n = self._online_warp_inputs(self.clusters[ld][m])
        self.warp_counts["online"] += 1
        res = self._warp_fn_online(self._xb_dev, self._f64(y_ld[None, :]),
                                   mean, prior, 1.0, 1.0, n)
        lik = res.lik_data[0] + warp_prior_score(prior, res.x_warp)[0]
        return (res.y_warp[0].cpu().numpy(), res.x_warp[0].cpu().numpy(),
                float(lik))

    def _compute_warp_y_online(self, y_ld, ld, force_model=None,
                               method: Optional[str] = None):
        """Online warp strategies (compute_warp_y, GPI_HDP.py:3153-3322):

        * ``standard`` — warp against every non-empty cluster;
        * ``greedy`` — rank clusters by estimate_new score, warp in
          order until the gain-ratio gate closes (:3300-3313);
        * ``greedy_bound`` — greedy order with a hard cap of 4 warps
          (:3270-3276 ``if i >= 3: break``);
        * ``force_model`` — warp only against that cluster (:3198-3226).

        The reference's liks vector has ONE entry per model (length M)
        and the birth candidate reads liks[-1]: the birth slot ALIASES
        the last model's entry, with the final ``liks[-1] +=
        max(liks[:-1])`` increment (GPI_HDP.py:3177-3181). The vector
        returned has length M + 1, its birth slot a copy of entry M - 1.
        At M == 1 the max runs over an empty slice (a crash in the
        reference); here it is 0, as in hdpgpc_tpu."""
        M = self.M
        T = self.Tb
        method = method or self.cfg.warp.method
        prior = self._warp_setup()
        base = float(warp_prior_score(
            prior, torch.zeros((1, T), dtype=torch.float64,
                               device=self.device))[0])
        liks = np.full(M, base)

        def _empty_max(a):
            return a.max() if a.size else 0.0

        def _done():
            return y_w, x_w, np.concatenate([liks, liks[-1:]])

        y_w = np.tile(y_ld[:, None], (1, M))
        x_w = np.zeros((T, M))

        if force_model is not None:
            m = int(force_model)
            if self.clusters[ld][m].members.size > 0:
                y_w[:, m], x_w[:, m], liks[m] = self._warp_one(
                    y_ld, ld, m, prior)
            else:
                liks[m] += _empty_max(liks[:-1])
            liks[-1] += _empty_max(liks[:-1])
            return _done()

        if method == "standard":
            for m in range(M):
                if self.clusters[ld][m].members.size > 0:
                    y_w[:, m], x_w[:, m], liks[m] = self._warp_one(
                        y_ld, ld, m, prior)
                else:
                    liks[m] += _empty_max(liks[:-1])
            liks[-1] += _empty_max(liks[:-1])
            return _done()

        # greedy / greedy_bound: rank clusters by estimate_new scores
        # (one batched call over the lead's clusters)
        q_C = gplds.estimate_new(
            self._stacked_lead(ld),
            self._dev(y_ld)[None].expand(M, T)).cpu().numpy()
        order = np.argsort(-q_C)

        if method == "greedy_bound":
            for i, m in enumerate(order):
                m = int(m)
                if self.clusters[ld][m].members.size > 0:
                    y_w[:, m], x_w[:, m], liks[m] = self._warp_one(
                        y_ld, ld, m, prior)
                else:
                    liks[m] += liks[order[:i + 1]].max()
                if i >= 3:
                    break
            liks[-1] += _empty_max(liks[:-1])
            return _done()

        if method != "greedy":
            raise ValueError(f"unknown warp strategy {method!r} "
                             "(standard | greedy | greedy_bound)")
        for i, m in enumerate(order):
            m = int(m)
            cl = self.clusters[ld][m]
            if cl.members.size == 0:
                liks[m] += _empty_max(liks[:-1])
                continue
            y_w[:, m], x_w[:, m], liks[m] = self._warp_one(y_ld, ld, m,
                                                           prior)
            # greedy gate (GPI_HDP.py:3300-3313)
            if i < M - 1 and i < 8:
                num = q_C[m] + liks[m] * 0.5 - q_C[order[i + 1]]
                den = q_C[m] - q_C[order[i + 1]]
                n_mem = max(int(cl.members.size), 1)
                if den != 0 and (num / den > 0.3 / (np.log(n_mem + 1))
                                 or i == 5):
                    for j_ in order[i + 1:]:
                        liks[int(j_)] += liks[order[:i + 1]].max()
                    liks[-1] += _empty_max(liks[:-1])
                    break
            else:
                for j_ in order[i + 1:]:
                    liks[int(j_)] += liks[order[:i + 1]].max()
                liks[-1] += _empty_max(liks[:-1])
                break
        return _done()

    def compute_warp_actual_state(self, x_trains, y_trains, q=None,
                                  q_lat=None):
        """Post-hoc warp of every assigned beat against its own cluster
        (compute_warp_actual_state[_amtgp], GPI_HDP.py:949-1023), one
        batched online-count warp per (lead, cluster).

        Returns (q, q_lat, warp_computed, y_trains_w). When q/q_lat are
        given they are rescored under the warped beats via fresh-state
        refits, as in hdpgpc_tpu."""
        y = np.asarray(y_trains, np.float64)
        if y.ndim == 2:
            y = y[:, :, None]
        N, T, L = y.shape
        y_w_out = y.copy()
        self.x_w = np.zeros_like(y)
        self.liks_w = np.zeros((N, L))
        prior = self._warp_setup()
        for ld in range(L):
            for m, cl in enumerate(self.clusters[ld]):
                idx = cl.members
                if idx.size == 0:
                    continue
                mean, n = self._online_warp_inputs(cl)
                res = self._warp_fn_online(self._xb_dev,
                                           self._f64(y[idx, :, ld]), mean,
                                           prior, 1.0, 1.0, n)
                lk = res.lik_data + warp_prior_score(prior, res.x_warp)
                y_w_out[idx, :, ld] = res.y_warp.cpu().numpy()
                self.x_w[idx, :, ld] = res.x_warp.cpu().numpy()
                self.liks_w[idx, ld] = lk.cpu().numpy()
            if q is not None:
                for m, cl in enumerate(self.clusters[ld]):
                    rc = np.zeros(N)
                    rc[cl.members] = 1.0
                    q_col, ql_col, _snr, _cl = self._full_refit(
                        cl, ld, y_w_out[:, :, ld], rc)
                    q[:, m, ld] = q_col
                    q_lat[:, m, ld] = ql_col
        return q, q_lat, True, y_w_out

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

    def compute_Pi(self) -> np.ndarray:
        """Posterior-mean transition matrix (GPI_HDP.compute_Pi,
        GPI_HDP.py:424-429)."""
        from scipy.special import digamma
        d = digamma(self.glob.trans_theta)
        return np.exp(d - np.log(np.sum(np.exp(d), axis=1))[:, None])

    # ------------------------------------------------------------------
    # Offline batch VI (GPI_HDP.include_batch, GPI_HDP.py:805-947)
    # ------------------------------------------------------------------

    def include_batch(self, x_trains, y_trains, it_limit: Optional[int] = None,
                      with_warp: bool = False):
        """Run the offline variational sweep over a batch of beats.

        x_trains: (N, T) or (N, T, 1) time grids (shared grid assumed);
        y_trains: (N, T, L).
        """
        self.warp = bool(with_warp)
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
            # the refill decides whether the loop goes on, so it precedes
            # its sweep's span: the pass that ends here records no sweep
            with span("sweep.refill"):
                resp, respPair, end = self._refill(resp, respPair)
            M = self.M
            if resp.shape[1] == 1:
                self._hdp_global_update(resp, respPair, M, n_iters=2)
            if end:
                break
            with span("sweep"):
                (resp, respPair, q, q_lat, snr, y_w,
                 reallocate) = self._vlt_batch(M, x, y, y_w, resp, respPair,
                                               q, q_lat, snr, reallocate)
                if resp.shape[1] > M:
                    self.M = M + 1
                    M = self.M
                elif resp.shape[1] < M:
                    # Emergency group removal shrank the bank mid-sweep
                    # (GPI_HDP.py:1451-1460 trims gpmodels but never
                    # resyncs self.M — a latent reference crash in
                    # _calcThetaFull on the next global update). Resync
                    # to the live count.
                    self.M = resp.shape[1]
                    M = self.M
                self._hdp_global_update(resp, respPair, M, n_iters=2)
                if self.T_count <= 1:
                    break
                with span("sweep.elbo"):
                    elbo_ = float(hmm_ops.entropy_terms(
                        torch.as_tensor(resp, dtype=self.dtype,
                                        device=self.device),
                        torch.as_tensor(respPair, dtype=self.dtype,
                                        device=self.device)))
                    print(f"\n-------End Lower Bound Iteration "
                          f"{iteration}-------")
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
            with span("sweep.first"):
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
                with span("sweep.q_all"):
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
            with span("first.cold_init"):
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
        with span("first.q_simple"):
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
            with span("first.realloc_trial"):
                q_aux = q_simple.copy()
                if resp.sum(axis=0)[-1] == 0:
                    q_aux[:, -1, :] = np.min(q_aux) * 2.0
                    snr_aux[:, -1, :] = np.min(snr_aux) * 2.0
                q_norm = self.weight_mean(q_aux, snr_aux)
                q_norm = q_norm - q_norm.max(axis=1, keepdims=True)
                resp_temp, respPair_temp = self._fb_hard(q_norm, startPi,
                                                         transPi)
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
                        if y_w.shape[3] == M:
                            y_w = y_w[:, :, :, reorder]
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
                        print("Emergency reallocation and removing last "
                              "group.")
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
        with span("first.birth_rank"):
            assigned = np.flatnonzero(resp.sum(axis=1) >= 1.0)
            q_sim_s = self._normalized_rank(
                self.weight_mean(q_simple)[resp == 1.0])
            q_s = self._normalized_rank(self.weight_mean(q_)[resp == 1.0])
            q_lat_s = self._normalized_rank(
                self.weight_mean(q_lat_)[resp == 1.0])
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
                    m_old = min(m_chosen, f_ind_old.shape[0] - 1)
                    if f_ind_new == int(f_ind_old[m_old]):
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

            with span("first.birth_trial"):
                count("birth.trials")
                if not empty_estimation:
                    f_ind_temp = f_ind_grow.copy()
                    f_ind_temp[-1] = f_ind_new
                    y_w, x_w, liks = self._warp_by_resp(x, y, resp_g,
                                                        f_ind_temp)
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
                        print("Emergency reallocation and removing last "
                              "group.")
                        reallocate = True
                        for ld in range(L):
                            clusters_temp[ld] = clusters_temp[ld][:-1]
                        resp_temp, respPair_temp, q, q_lat, snr_aux = \
                            self._drop_last_col(resp_temp, respPair_temp, q,
                                                q_lat, snr_aux)
                        self.clusters = clusters_temp
                        Mk = resp_temp.shape[1]
                        self.f_ind_old = f_ind_grow[reorder][:Mk]
                        y_w = y_w[:, :, :, reorder][:, :, :, :Mk]
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
                        count("birth.accepted")
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
    # Legacy HMM surface: compute_h / baum_welch (GPI_HDP.py:3824-3931)
    # ------------------------------------------------------------------

    def _log_messages(self):
        """Log forward/backward messages and the log pair posterior over
        the current fused evidence."""
        if self.q_last is None:
            raise ValueError("no evidence yet: include samples first")
        q_w = torch.as_tensor(self.weight_mean(self.q_last),
                              device=self.device)
        q_norm, _ = hmm_ops.row_normalize_log(q_w, axis=1)
        startPi, _ = self._pis(self.M)
        transPi = torch.as_tensor(self._trans_log_pi_for_K(self.M),
                                  device=self.device)
        spn = torch.as_tensor(np.asarray(startPi)[:self.M],
                              device=self.device)
        alpha, _ = hmm_ops.forward(spn, transPi, q_norm)
        beta = hmm_ops.backward(transPi, q_norm)
        log_psi = hmm_ops.coupled_pair_log(alpha, beta, transPi, q_norm)
        return torch.log(alpha), torch.log(beta), log_psi

    def compute_h(self, time: Optional[int] = None) -> np.ndarray:
        """Posterior state log-marginals h (GPI_HDP.compute_h,
        GPI_HDP.py:3824-3862); ``time`` selects one row."""
        log_alpha, log_beta, _ = self._log_messages()
        h = hmm_ops.posterior_log_marginals(log_alpha, log_beta).cpu().numpy()
        return h if time is None else h[time]

    def baum_welch(self):
        """Legacy re-estimation of (pi, trans) by Baum-Welch
        (GPI_HDP.baum_welch, GPI_HDP.py:3864-3931); with
        ``hmm_switch=False`` the current pis, unchanged (:3930-3931)."""
        if not self.cfg.hmm_switch:
            startPi, _ = self._pis(self.M)
            return (np.asarray(startPi)[:self.M],
                    self._trans_log_pi_for_K(self.M))
        return hmm_ops.baum_welch(*self._log_messages())

    # ------------------------------------------------------------------
    # Online streaming VI (GPI_HDP.include_sample, GPI_HDP.py:1906-2208;
    # the cached step include_sample_fast, :2312-2629). Warp off.
    # ------------------------------------------------------------------

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _ensure_online_buffers(self, L):
        if self._y_all is None:
            self._y_all = np.zeros((0, self.Tb, L))
        if self.q_last is None:
            self.q_last = np.zeros((self.T_count, self.M, L)) - np.inf
        if self.q_lat_last is None:
            self.q_lat_last = np.zeros((self.T_count, self.M, L))
        if self.resp_last is None:
            self.resp_last = np.zeros((self.T_count, self.M))
            self.respPair_last = np.zeros((self.T_count, self.M, self.M))
            if self.T_count > 0:
                self.resp_last[0, 0] = 1.0
                self.respPair_last[0, 0, 0] = 1.0

    def _online_include(self, cl: Cluster, y: np.ndarray, t: int,
                        update_params: bool, pair_smooth: bool) -> Cluster:
        """One beat through a one-member refit (no final RTS pass)."""
        prog = self._refit_prog(update_params=update_params,
                                pair_smooth=pair_smooth, full_backward=False)
        res = prog(self._dev(y[None, :]), self._dev(np.ones(1)), cl.state)
        return Cluster(res.state, cl.fitted, np.append(cl.members, t))

    def _include_one(self, cl: Cluster, ld: int, y: np.ndarray, t: int
                     ) -> Cluster:
        """Online commit of one beat: kernel fit if first-ever, Kalman
        include + 1-step MNIW update WITHOUT pair smoothing
        (GPI_HDP.py:2185-2197).

        ML mode (bayesian_params=False): the include is a plain filter
        step, and parameter re-estimation follows the new_params_weighted
        cadence (GPI_model.py:874-887): a full masked EM over the
        cluster's member history at cadence beats."""
        cl = self._maybe_kernel_fit_online(cl, ld, y)
        bayes = self.cfg.bayesian_params
        out = self._online_include(cl, y, t, bayes, False)
        members = out.members
        if (not bayes and ml_em.reestimate_cadence(members.size)
                and self._y_all is not None and members.size >= 2
                and members[-1] < self._y_all.shape[0]):
            rc = np.zeros(self._y_all.shape[0])
            rc[members] = 1.0
            out = self._full_refit_ml(out, ld, self._y_all[:, :, ld], rc)[3]
        return out

    def _maybe_kernel_fit_online(self, cl: Cluster, ld: int, y: np.ndarray
                                 ) -> Cluster:
        # members mirrors state.n on the host (no device read)
        if cl.fitted or cl.members.size > 0:
            return cl
        key = self._fit_key(y)
        theta = self._kernel_fit_cache.get(key)
        if theta is None:
            theta = self._fit_theta(y)
            self._kernel_fit_cache[key] = theta
        st = gplds.apply_kernel_fit(cl.state, self._xb_dev, theta)
        return Cluster(st, True, cl.members)

    def _birth_include(self, cl: Cluster, ld: int, y: np.ndarray,
                       t: int) -> Cluster:
        """Birth-candidate include: a bare include on the reinit template
        copy, no pair smoothing and no parameter update, so Gamma/Sigma
        stay at the template defaults (GPI_HDP.py:1996-2005)."""
        cl = self._maybe_kernel_fit_online(cl, ld, y)
        return self._online_include(cl, y, t, False, False)

    def _candidate_include(self, cl: Cluster, ld: int, y: np.ndarray,
                           t: int) -> Cluster:
        """Absorb-candidate include: Kalman + pair smoothing + MNIW
        (GPI_HDP.py:2026-2032). In ML mode a plain filter step: as in
        hdpgpc_tpu, no cadence EM on a one-step lookahead."""
        cl = self._maybe_kernel_fit_online(cl, ld, y)
        return self._online_include(cl, y, t, self.cfg.bayesian_params,
                                    True)

    @staticmethod
    def _patch_q_lat_vals(col: np.ndarray, members_new: np.ndarray,
                          tails, only_idxs=None) -> np.ndarray:
        """Scatter q_lat tail values (first, prev, last) at the member
        indices, restricted to ``only_idxs`` (the include_sample_fast
        tail-patch contract, _update_q_lat_tail, GPI_HDP.py:2273-2285)."""
        vf, vp, vl = (float(v) for v in tails)
        col = col.copy()
        patch = {int(members_new[0]): vf}
        if members_new.size >= 2:
            patch[int(members_new[-1])] = vl
        if members_new.size >= 3:
            patch[int(members_new[-2])] = vp
        for idx, v in patch.items():
            if only_idxs is None or idx in only_idxs:
                col[idx] = v
        return col

    def _patch_q_lat_col(self, col: np.ndarray, cl: Cluster) -> np.ndarray:
        """Refresh the only q_lat entries an online step can change: the
        first / second-to-last / last members' latent scores
        (compute_q_lat_all semantics via the compact summary)."""
        if cl.members.size == 0 or self.cfg.gp.model_type != "dynamic":
            return col
        tails = torch.stack(gplds.q_lat_tail(cl.state)).cpu().numpy()
        return self._patch_q_lat_vals(col, cl.members, tails)

    @staticmethod
    def _append_hard_step(resp_prev: np.ndarray, respPair_prev: np.ndarray,
                          new_state: int, K: int):
        """Append one hard step to cached responsibilities (reference
        _append_hard_step, GPI_HDP.py:2287-2310)."""
        T_prev = resp_prev.shape[0]
        resp = np.zeros((T_prev + 1, K))
        resp[:T_prev, :resp_prev.shape[1]] = resp_prev
        resp[T_prev, new_state] = 1.0
        respPair = np.zeros((T_prev + 1, K, K))
        if respPair_prev is not None and respPair_prev.size > 0:
            respPair[:T_prev, :respPair_prev.shape[1],
                     :respPair_prev.shape[2]] = respPair_prev
        if T_prev == 0:
            respPair[T_prev, new_state, new_state] = 1.0
        else:
            prev_state = int(np.argmax(resp_prev[-1]))
            respPair[T_prev, prev_state, new_state] = 1.0
        return resp, respPair

    def _stacked_lead(self, ld: int) -> ClusterState:
        """The lead's cluster states stacked on a leading dim, kept on the
        device across online steps: a step that changed one cluster costs
        one slot write, a reorder one gather, instead of a restack."""
        clusters = self.clusters[ld]
        ids = tuple(cl.uid for cl in clusters)
        cached = self._stack_cache.get(ld)
        tree = None
        if cached is not None:
            old_ids, tree = cached
            if old_ids != ids:
                diff = [i for i, (a, b) in enumerate(zip(old_ids, ids))
                        if a != b]
                if len(old_ids) == len(ids) and len(diff) == 1:
                    i = diff[0]
                    tree = gplds.tree_map(
                        lambda a, b: a.index_copy(
                            0, torch.tensor([i], device=a.device), b[None]),
                        tree, clusters[i].state)
                elif len(old_ids) == len(ids) and set(old_ids) == set(ids):
                    perm = torch.tensor([old_ids.index(x) for x in ids],
                                        device=self.device)
                    tree = gplds.tree_map(lambda a: a[perm], tree)
                else:
                    tree = None
        if tree is None:
            tree = gplds.stack_states([cl.state for cl in clusters])
        self._stack_cache[ld] = (ids, tree)
        return tree

    def _score_last_all(self, ld: int, y_per_cluster: np.ndarray
                        ) -> np.ndarray:
        """log_sq_error(i=-1) against every cluster of the lead in one
        batched call (y_per_cluster (M, T)); the same fetch refreshes each
        cluster's memoised LDS parameter ELBO."""
        states = self._stacked_lead(ld)
        fd = float(self.cfg.gp.free_deg_mniw)
        packed = torch.stack([
            gplds.log_sq_error_last(states, self._dev(y_per_cluster)),
            gplds.lds_param_elbo(states, fd)], 1).cpu().numpy()
        for mm, cl in enumerate(self.clusters[ld]):
            if cl.lds_elbo is None:
                cl.lds_elbo = float(packed[mm, 1])
        return packed[:, 0]

    def _eval_candidates(self, ld: int, y_mod: np.ndarray, m_template: int):
        """Every candidate of include_sample_fast in one batched
        evaluation and one fetch per (beat, lead): slots 0..M-1 absorb
        the beat into cluster m (pair-smoothed include), slot M is the
        birth (a bare include on the reinit template, GPI_HDP.py:2444-2458).
        Returns (est (M+1,), tails (M+1, 3), lds (M+1,))."""
        M = self.M
        fd = float(self.cfg.gp.free_deg_mniw)
        stacked = self._stacked_lead(ld)
        Ys = self._dev(np.stack([y_mod[:, ld, mm] for mm in range(M)]
                                + [y_mod[:, ld, -1]]))
        refit_abs = self._refit_prog(
            update_params=self.cfg.bayesian_params, pair_smooth=True,
            full_backward=False)
        refit_birth = self._refit_prog(update_params=False,
                                       pair_smooth=False,
                                       full_backward=False)
        birth = gplds.reinit_cluster_state(
            gplds.index_state(stacked, m_template), fd)
        res_a = refit_abs(Ys[:M, None], self._dev(np.ones((M, 1))), stacked)
        res_b = refit_birth(Ys[M:], self._dev(np.ones(1)), birth)
        outs_a = torch.stack([gplds.estimate_new(stacked, Ys[:M]),
                              *gplds.q_lat_tail(res_a.state, 1.0),
                              res_a.lds], 1)
        outs_b = torch.stack([gplds.estimate_new(birth, Ys[M]),
                              *gplds.q_lat_tail(res_b.state, 0.5),
                              res_b.lds])
        packed = torch.cat([outs_a, outs_b[None]]).cpu().numpy()
        return packed[:, 0], packed[:, 1:4], packed[:, 4]

    def _online_pis(self, M):
        """Online transPi/startPi use digamma-sum denominators
        (variational_local_terms, GPI_HDP.py:607-610)."""
        transPi = sb.trans_log_pi_from_theta(self.glob.trans_theta, M,
                                             log_sum_exp_form=False)
        startPi = sb.start_log_pi_from_theta(self.glob.start_theta, M,
                                             log_sum_exp_form=False)
        return startPi, transPi

    def _vlt_online(self, q, liks=None):
        """variational_local_terms (GPI_HDP.py:586-630): full-history FB
        on the fused q (T, K, L); returns the hard (resp, respPair)."""
        q = q.copy()
        if liks is not None:
            q[-1] = q[-1] + np.asarray(liks)[:, None]
        startPi, transPi = self._online_pis(self.M)
        if self.snr_norm.shape[0] != q.shape[0]:
            # classify calls score one extra (uncommitted) row; weight it
            # uniformly rather than growing the SNR state
            q_w = self.weight_mean(q, np.ones((q.shape[0], 1, q.shape[2])))
        else:
            q_w = self.weight_mean(q)
        return self._fb_hard(q_w - q_w.max(axis=1, keepdims=True), startPi,
                             transPi)

    def _online_begin(self, y, with_warp: bool, force_model,
                      classify: bool):
        """Shared head of the online steps: scale and shape the beat,
        grow the caches, and build the per-cluster inputs and warp scores
        (warp off: every cluster and the birth slot see the raw beat).

        The warp's gate is the ``with_warp`` argument alone (reference
        include_sample, GPI_HDP.py:1941-1951): an online run warps from
        its second beat. The birth slot is scored on y warped to the LAST
        model (y_mod[-1][-1], GPI_HDP.py:2002). ``liks`` is reassigned
        for every lead, so the last lead's warp scores enter every
        lead's row, as in the reference (GPI_HDP.py:1945-1951)."""
        t = self.T_count
        y = np.asarray(y, np.float64)
        if self._y_scale != 1.0:
            y = y / self._y_scale
        if y.ndim == 1:
            y = y[:, None]
        L = y.shape[1]
        assert L == self.n_outputs
        self._ensure_online_buffers(L)
        if not classify:
            self.T_count = t + 1
            self.snr_norm = np.ones((self.T_count, L))
            self._y_all = np.concatenate([self._y_all, y[None]], axis=0)
        M = self.M
        liks = np.zeros(M + 1)
        y_mod = np.broadcast_to(y[:, :, None], (self.Tb, L, M + 1)).copy()
        if with_warp and t > 0:
            for ld in range(L):
                y_w_ld, _x_w_ld, liks = self._compute_warp_y_online(
                    y[:, ld], ld, force_model)
                y_mod[:, ld, :M] = y_w_ld
                y_mod[:, ld, M] = y_w_ld[:, M - 1]
        q_aux = np.zeros((t + 1, M + 1, L)) - np.inf
        q_lat = np.zeros((t + 1, M + 1, L))
        if t > 0:
            q_aux[:-1, :self.q_last.shape[1], :] = self.q_last
            q_lat[:-1, :self.q_lat_last.shape[1], :] = self.q_lat_last
        return t, L, M, liks, y_mod, q_aux, q_lat

    def _online_commit(self, t, L, y_mod, resp, respPair, q_chos,
                       q_lat_chos, force_model):
        """Shared tail of the online steps (GPI_HDP.py:2543-2629): tie
        normalisation, birth, popularity reorder, 4 x HDP refresh and the
        commit. Returns (model, birth, reorder)."""
        M = self.M
        resp_mod = np.asarray(resp[-1], np.float64).copy()
        # tie normalisation at rtol 1e-2 (GPI_HDP.py:2082-2085)
        if np.sum(np.isclose(resp_mod, resp_mod.max(), rtol=1e-2)) > 1:
            h_argmax = int(np.nanargmax(resp_mod))
            resp_mod[:] = 0.0
            resp_mod[h_argmax] = 1.0
        model = int(np.argmax(resp_mod))
        if self.cfg.max_models is not None and model >= self.cfg.max_models:
            force_model = model = int(np.argmax(resp_mod[:-1]))
        if force_model is not None:
            resp_mod[:] = 0.0
            resp_mod[int(force_model)] = 1.0
            model = int(force_model)
            resp[-1, :] = 0.0
            resp[-1, model] = 1.0
            respPair[-1] = 0.0
            respPair[-1, model, model] = 1.0

        birth = model == self.M
        if birth:
            print("Birth of new model: ", self.M + 1)
            self.M += 1
            M = self.M
            for ld in range(L):
                self.clusters[ld].append(self._new_cluster())
            # the newborn uses the birth slot's input
            y_mod = np.concatenate([y_mod, y_mod[:, :, -1:]], axis=2)

        # reorder by group size (GPI_HDP.reorder, GPI_HDP.py:1091-1110)
        reorder = np.argsort(-resp[:, :M].sum(axis=0), kind="stable")
        resp_s = resp.copy()
        resp_s[:, :M] = resp[:, :M][:, reorder]
        respPair_s = respPair.copy()
        respPair_s[:, :M, :M] = respPair[:, :M, :M][:, reorder][:, :, reorder]
        q_chos[:, :M] = q_chos[:, :M][:, reorder]
        q_lat_chos[:, :M] = q_lat_chos[:, :M][:, reorder]
        for ld in range(L):
            self.clusters[ld][:M] = [self.clusters[ld][i] for i in reorder]
        resp, respPair = resp_s, respPair_s
        resp_mod = np.asarray(resp[-1, :M], np.float64)
        model = int(np.argmax(resp_mod))

        # ---- HDP global update (4 iterations; GPI_HDP.py:2113-2141) ----
        start_counts = resp[0, :M]
        trans_counts = respPair[:, :M, :M].sum(axis=0)
        if M > 2:
            self.glob = sb.reinit_globals(self.glob, M - 1, trans_counts,
                                          start_counts)
        if M >= 2:
            for _ in range(4):
                tt, st = sb.calc_theta_full(self.glob, trans_counts,
                                            start_counts, M)
                self.glob = sb.HDPGlobals(
                    self.glob.rho, self.glob.omega, tt, st, self.glob.gamma,
                    self.glob.trans_alpha, self.glob.start_alpha,
                    self.glob.kappa)
                self.glob = sb.optimise_globals(self.glob, M=self.M + 1)

        # ---- commit to the real clusters ----
        self.actual_state = model
        if self.verbose:
            print("Main model chosen:", model + 1)
        for ld in range(L):
            for m in range(M):
                hh = resp_mod[m] if m < resp_mod.shape[0] else 0.0
                src = reorder[m] if m < reorder.shape[0] else m
                y_commit = y_mod[:, ld, min(src, y_mod.shape[2] - 1)]
                if hh > 0.99:
                    self.clusters[ld][m] = self._include_one(
                        self.clusters[ld][m], ld, y_commit, t)
        self.resp_last = resp[:, :self.M].copy()
        self.respPair_last = respPair[:, :self.M, :self.M].copy()
        self.resp_assigned.append(np.argmax(resp[:, :self.M], axis=1))
        self.metrics.append(kind="online_step", t=t, model=model,
                            birth=bool(birth), n_clusters=self.M)
        return model

    def include_sample(self, x_train, y, with_warp: bool = True,
                       force_model=None, classify: bool = False):
        """Include one streaming beat: score, decide birth vs absorb by
        ELBO over the whole history, commit, update the HDP globals
        (GPI_HDP.py:1906-2208). ``with_warp`` warps the beat against the
        clusters from the second beat on, by ``cfg.warp.method``."""
        t, L, M, liks, y_mod, q_aux, q_lat = self._online_begin(
            y, with_warp, force_model, classify)
        for ld in range(L):
            scores = self._score_last_all(ld, y_mod[:, ld, :M].T)
            for m in range(M):
                q_aux[-1, m, ld] = scores[m] + liks[m]
                q_lat[:, m, ld] = self._patch_q_lat_col(
                    q_lat[:, m, ld], self.clusters[ld][m])

        if t > 0:
            resp, respPair = self._vlt_online(q_aux)
            snr_loc = None if self.snr_norm.shape[0] == t + 1 \
                else np.ones((t + 1, 1, L))
            q_all, elbo = self.compute_q_elbo(
                resp[:-1, :-1], respPair[:-1, :-1, :-1],
                self.weight_mean(q_aux, snr_loc)[:-1, :-1],
                self.weight_mean(q_lat, snr_loc)[:-1, :-1],
                self.clusters, self.M, snr="saved", post=False,
                one_sample=True, verb=self.verbose)
        else:
            q_all, elbo = 0.0, 0.0

        if classify:
            resp_mod = np.asarray(resp[-1]) if t > 0 else None
            return q_aux[:-1], resp_mod, liks[:-1]

        q_chos, q_lat_chos = q_aux, q_lat
        if t > 0 and force_model is None:
            q_ord = np.argsort(-self.weight_mean(q_aux)[-1, :-1],
                               kind="stable")
            m_template = int(q_ord[-1])

            # ===== birth candidate (GPI_HDP.py:1996-2013) =====
            q_prev = q_aux.copy()
            q_lat_prev = q_lat.copy()
            prov: List[Cluster] = []
            for ld in range(L):
                cl = self.clusters[ld][m_template]
                st = gplds.reinit_cluster_state(
                    cl.state, float(self.cfg.gp.free_deg_mniw))
                pc = Cluster(st, cl.fitted, state_key=cl.state_key)
                q_prev[-1, -1, ld] = float(gplds.estimate_new(
                    pc.state, self._dev(y_mod[:, ld, -1]))) + liks[-1]
                pc = self._birth_include(pc, ld, y_mod[:, ld, -1], t)
                q_lat_prev[:, -1, ld] = self._patch_q_lat_col(
                    q_lat_prev[:, -1, ld], pc)
                prov.append(pc)
            resp_prev, respPair_prev = self._vlt_online(q_prev, liks)
            clusters_birth = [list(self.clusters[ld]) + [prov[ld]]
                              for ld in range(L)]
            q_prev_post, elbo_prev_post = self.compute_q_elbo(
                resp_prev, respPair_prev, self.weight_mean(q_prev),
                self.weight_mean(q_lat_prev), clusters_birth, self.M,
                snr="saved", post=True, one_sample=True, verb=self.verbose)
            elbo_prev_post -= elbo
            q_prev_post -= q_all

            if int(np.argmax(self.weight_mean(q_prev)[-1])) == self.M:
                # ===== absorb candidates in q-order (GPI_HDP.py:2022-2059)
                q_post = q_aux.copy()
                q_lat_post = q_lat.copy()
                chosen = None
                for m_cand in q_ord:
                    m_cand = int(m_cand)
                    clusters_post = [list(self.clusters[ld])
                                     for ld in range(L)]
                    for ld in range(L):
                        cl = self.clusters[ld][m_cand]
                        q_post[-1, m_cand, ld] = float(gplds.estimate_new(
                            cl.state, self._dev(y_mod[:, ld, m_cand]))) \
                            + liks[m_cand]
                        cc = self._candidate_include(
                            cl.clone(), ld, y_mod[:, ld, m_cand], t)
                        q_lat_post[:, m_cand, ld] = self._patch_q_lat_col(
                            q_lat_post[:, m_cand, ld], cc)
                        clusters_post[ld][m_cand] = cc
                    resp_post, respPair_post = self._vlt_online(q_post, liks)
                    q_bas_post, elbo_bas_post = self.compute_q_elbo(
                        resp_post[:, :-1], respPair_post[:, :-1, :-1],
                        self.weight_mean(q_post)[:, :-1],
                        self.weight_mean(q_lat_post)[:, :-1],
                        clusters_post, self.M, snr="saved", post=False,
                        one_sample=True, verb=self.verbose)
                    elbo_bas_post -= elbo
                    q_bas_post -= q_all
                    if q_bas_post + elbo_bas_post \
                            > q_prev_post + elbo_prev_post:
                        chosen = m_cand
                        break
                if chosen is not None:
                    q_chos, q_lat_chos = q_post, q_lat_post
                    resp, respPair = self._vlt_online(q_chos, liks)
                else:
                    q_chos, q_lat_chos = q_prev, q_lat_prev
                    resp, respPair = resp_prev, respPair_prev
            else:
                resp, respPair = self._vlt_online(q_chos, liks)
        elif t == 0:
            init_state = 0 if force_model is None else int(force_model)
            resp = np.zeros((1, M + 1))
            resp[0, init_state] = 1.0
            respPair = np.zeros((1, M + 1, M + 1))
            respPair[0, init_state, init_state] = 1.0
        else:
            resp, respPair = self._vlt_online(q_chos, liks)

        model = self._online_commit(t, L, y_mod, resp, respPair, q_chos,
                                    q_lat_chos, force_model)
        # refresh the caches, every latent tail recomputed
        self.q_last = q_chos[:, :self.M, :].copy()
        ql = q_lat_chos[:, :self.M, :].copy()
        for ld in range(L):
            for m in range(self.M):
                ql[:, m, ld] = self._patch_q_lat_col(
                    ql[:, m, ld], self.clusters[ld][m])
        self.q_lat_last = ql
        return model

    def include_sample_fast(self, x_train, y, with_warp: bool = True,
                            force_model=None, classify: bool = False):
        """O(1)-per-beat cached online step (GPI_HDP.include_sample_fast,
        GPI_HDP.py:2312-2629). Its approximations relative to
        ``include_sample`` are the reference's:

        * past resp/respPair are reused; the new step is appended as a
          hard one-hot (+ hard transition pair) instead of re-running
          forward-backward over the history (GPI_HDP.py:2287-2310);
        * q_lat is patched only at tail indices t / t-1
          (GPI_HDP.py:2273-2285);
        * the birth candidate's q_lat column uses h_ini=0.5 and is scaled
          by 5.0 (GPI_HDP.py:2460, a reference quirk kept here).

        The warp is that of ``include_sample``."""
        t, L, M, liks, y_mod, q_aux, q_lat = self._online_begin(
            y, with_warp, force_model, classify)
        for ld in range(L):
            scores = self._score_last_all(ld, y_mod[:, ld, :M].T)
            q_aux[-1, :M, ld] = scores + liks[:M]

        if classify:
            if t > 0:
                resp, _ = self._vlt_online(q_aux)
                return q_aux[:-1], np.asarray(resp[-1]), liks[:-1]
            return q_aux[:-1], None, liks[:-1]

        Tn = t + 1
        q_chos, q_lat_chos = q_aux, q_lat
        if t == 0:
            init_state = 0 if force_model is None else int(force_model)
            resp = np.zeros((1, M + 1))
            resp[0, init_state] = 1.0
            respPair = np.zeros((1, M + 1, M + 1))
            respPair[0, init_state, init_state] = 1.0
        else:
            # baseline on the cached history; SNR sliced to the history
            # rows (GPI_HDP.py:2419-2426 snr_norm[:-1])
            snr_hist = np.ones((t, 1, L))
            base_q, base_elbo = self.compute_q_elbo(
                self.resp_last, self.respPair_last,
                self.weight_mean(self.q_last, snr_hist),
                self.weight_mean(self.q_lat_last, snr_hist),
                self.clusters, self.M, snr="saved", post=False,
                one_sample=True, verb=False)
            base_total = base_q + base_elbo
            m_best_sse = int(np.argmax(self.weight_mean(q_aux)[-1, :-1]))
            resp_h, respPair_h = self._append_hard_step(
                self.resp_last, self.respPair_last, m_best_sse, M)
            resp = np.zeros((Tn, M + 1))
            resp[:, :M] = resp_h
            respPair = np.zeros((Tn, M + 1, M + 1))
            respPair[:, :M, :M] = respPair_h

        if t > 0 and force_model is None:
            q_ord = np.argsort(-self.weight_mean(q_aux)[-1, :-1],
                               kind="stable")
            m_template = int(q_ord[-1])

            # ===== every candidate (absorb x M + birth) in one batched
            # evaluation per lead (the math of GPI_HDP.py:2444-2541) =====
            ests = np.zeros((M + 1, L))
            tails = np.zeros((M + 1, 3, L))
            lds_new = np.zeros((M + 1, L))
            for ld in range(L):
                ests[:, ld], tails[:, :, ld], lds_new[:, ld] = \
                    self._eval_candidates(ld, y_mod, m_template)

            # ===== birth candidate (GPI_HDP.py:2444-2463) =====
            q_prev = q_aux.copy()
            q_lat_prev = q_lat.copy()
            prov: List[Cluster] = []
            mem_birth = np.asarray([t], np.int64)
            for ld in range(L):
                q_prev[-1, -1, ld] = ests[M, ld] + liks[-1]
                q_lat_prev[:, -1, ld] = self._patch_q_lat_vals(
                    q_lat_prev[:, -1, ld], mem_birth, tails[M, :, ld],
                    only_idxs=(t,)) * 5.0
                pc = Cluster(None, self.clusters[ld][m_template].fitted,
                             mem_birth)
                pc.lds_elbo = float(lds_new[M, ld])
                prov.append(pc)

            # gate: compare absorb only when birth wins on emission
            if int(np.argmax(self.weight_mean(q_prev)[-1])) == M:
                resp_birth, respPair_birth = self._append_hard_step(
                    self.resp_last, self.respPair_last, M, M + 1)
                clusters_birth = [list(self.clusters[ld]) + [prov[ld]]
                                  for ld in range(L)]
                q_b, elbo_b = self.compute_q_elbo(
                    resp_birth, respPair_birth, self.weight_mean(q_prev),
                    self.weight_mean(q_lat_prev), clusters_birth, M + 1,
                    snr="saved", post=True, one_sample=True, verb=False)
                best_total = (q_b + elbo_b) - base_total
                best_pack = (q_prev, q_lat_prev, resp_birth, respPair_birth)

                # ===== absorb candidates in q-order (GPI_HDP.py:2484-2541)
                for m_cand in q_ord:
                    m_cand = int(m_cand)
                    q_post = q_aux.copy()
                    q_lat_post = q_lat.copy()
                    clusters_post = [list(self.clusters[ld])
                                     for ld in range(L)]
                    for ld in range(L):
                        cl = self.clusters[ld][m_cand]
                        q_post[-1, m_cand, ld] = ests[m_cand, ld] \
                            + liks[m_cand]
                        mem_new = np.append(cl.members, t)
                        q_lat_post[:, m_cand, ld] = self._patch_q_lat_vals(
                            q_lat_post[:, m_cand, ld], mem_new,
                            tails[m_cand, :, ld], only_idxs=(t, t - 1))
                        cc = Cluster(None, cl.fitted, mem_new)
                        cc.lds_elbo = float(lds_new[m_cand, ld])
                        clusters_post[ld][m_cand] = cc
                    resp_abs, respPair_abs = self._append_hard_step(
                        self.resp_last, self.respPair_last, m_cand, M)
                    q_a, elbo_a = self.compute_q_elbo(
                        resp_abs, respPair_abs,
                        self.weight_mean(q_post)[:, :M],
                        self.weight_mean(q_lat_post)[:, :M],
                        clusters_post, self.M, snr="saved", post=False,
                        one_sample=True, verb=False)
                    if (q_a + elbo_a) - base_total > best_total:
                        resp_full = np.zeros((Tn, M + 1))
                        resp_full[:, :M] = resp_abs
                        respPair_full = np.zeros((Tn, M + 1, M + 1))
                        respPair_full[:, :M, :M] = respPair_abs
                        best_pack = (q_post, q_lat_post, resp_full,
                                     respPair_full)
                        break
                q_chos, q_lat_chos, resp, respPair = best_pack

        model = self._online_commit(t, L, y_mod, resp, respPair, q_chos,
                                    q_lat_chos, force_model)
        # refresh the caches verbatim (stale non-tail entries are the
        # documented fast-path approximation, GPI_HDP.py:2620-2626)
        self.q_last = q_chos[:, :self.M, :].copy()
        self.q_lat_last = q_lat_chos[:, :self.M, :].copy()
        return model

    # ------------------------------------------------------------------
    # Classification / continued learning (GPI_HDP.py:2975-3151)
    # ------------------------------------------------------------------

    def _score_clusters(self, ld: int, Y: np.ndarray) -> np.ndarray:
        """q (N, M): every beat of Y (N, T) against every cluster of lead
        ``ld`` (mean C f_last, covariance Sigma), in one kernel-B
        launch (models/streaming.emission_scores)."""
        st = gplds.stack_states([cl.state for cl in self.clusters[ld]])
        return emission_scores(
            torch.as_tensor(Y, dtype=self.dtype, device=self.device),
            (st.C @ st.f_last)[..., 0], st.Sigma).cpu().numpy()

    def _refit_reordered(self, ld: int, Y: np.ndarray, resp: np.ndarray,
                         reorder: np.ndarray):
        """Refit column m of ``resp`` from cluster ``reorder[m]`` of lead
        ``ld``, for every m, in batched calls. The reference does this in
        one loop that overwrites ``clusters[ld][m]`` as it goes, so a
        job whose source index is below its own reads the REFITTED
        cluster (hdpgpc.py:3250-3258); such a job waits for the job that
        wrote its source. Returns the (q, q_lat, snr, Cluster) per m."""
        M = len(reorder)
        src = self.clusters[ld]
        out: list = [None] * M
        todo = list(range(M))
        while todo:
            ready = [m for m in todo
                     if reorder[m] >= m or out[reorder[m]] is not None]
            jobs = [(src[reorder[m]] if reorder[m] >= m
                     else out[reorder[m]][3], ld, Y, resp[:, m])
                    for m in ready]
            for m, r in zip(ready, self._full_refit_batch(jobs)):
                out[m] = r
            todo = [m for m in todo if out[m] is None]
        return out

    def cluster_new_batch(self, x_trains, y_trains, learning: bool = False,
                          it_limit: Optional[int] = None,
                          with_warp: bool = False):
        """Score new beats against the trained clusters and return their
        labels; with ``learning`` absorb them and go on training
        (GPI_HDP.cluster_new_batch): the histories are concatenated,
        the clusters reordered by size and refit, and the offline sweep
        re-entered (at most ``it_limit`` sweeps)."""
        y = np.asarray(y_trains, np.float64)
        if self._y_scale != 1.0:
            y = y / self._y_scale
        if y.ndim == 2:
            y = y[:, :, None]
        N, T, L = y.shape
        M = self.M
        q = np.zeros((N, M, L))
        snr = np.zeros((N, M, L))
        for ld in range(L):
            q[:, :, ld] = self._score_clusters(ld, y[:, :, ld])
            for m in range(M):
                f = self.clusters[ld][m].state.f_sm_last[:, 0].cpu().numpy()
                num = np.sum(f**2)
                den = np.sum((y[:, :, ld] - f[None]) ** 2, axis=1)
                snr[:, m, ld] = 10.0 * (np.log10(max(num, 1e-300))
                                        - np.log10(np.maximum(den, 1e-300)))
        startPi, transPi = self._online_pis(M)
        q_w = self.weight_mean(q, snr)
        resp, respPair = self._fb_hard(q_w - q_w.max(axis=1, keepdims=True),
                                       startPi, transPi)
        if not learning:
            return np.argmax(resp, axis=1)

        # continued learning: concatenate histories and re-enter the
        # offline sweep (GPI_HDP.py:3002-3151)
        y_all = np.concatenate([self._y_all, y], axis=0) \
            if self._y_all is not None and self._y_all.shape[0] else y
        self.T_count = y_all.shape[0]
        self._y_all = y_all
        resp_full = np.concatenate([self.resp_last, resp], axis=0) \
            if self.resp_last is not None else resp
        respPair_full = np.concatenate([self.respPair_last, respPair],
                                       axis=0) \
            if self.respPair_last is not None else respPair
        self.snr_norm = np.concatenate(
            [self.snr_norm, self.normalize_snr(snr)], axis=0) \
            if self.snr_norm.shape[0] else self.normalize_snr(snr)
        reorder = np.argsort(-resp_full.sum(axis=0), kind="stable")
        resp_full = resp_full[:, reorder]

        Nf = y_all.shape[0]
        q = np.zeros((Nf, M, L))
        q_lat = np.zeros((Nf, M, L))
        snr_f = np.zeros((Nf, M, L))
        x_full = np.tile(self.x_basis, (Nf, 1))
        for ld in range(L):
            res = self._refit_reordered(ld, y_all[:, :, ld], resp_full,
                                        reorder)
            for m, (q_col, ql_col, s_col, cl2) in enumerate(res):
                q[:, m, ld] = q_col
                q_lat[:, m, ld] = ql_col
                snr_f[:, m, ld] = s_col
                self.clusters[ld][m] = cl2
        q_w = self.weight_mean(q, snr_f)
        resp, respPair = self._fb_hard(q_w - q_w.max(axis=1, keepdims=True),
                                       startPi, transPi)
        iteration = 0
        reallocate = False
        y_w = np.broadcast_to(y_all[..., None], (Nf, T, L, M))
        while True:
            resp, respPair, end = self._refill(resp, respPair)
            M = self.M
            if end:
                break
            (resp, respPair, q, q_lat, snr_f, y_w,
             reallocate) = self._vlt_batch(M, x_full, y_all, y_w, resp,
                                           respPair, q, q_lat, snr_f,
                                           reallocate)
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
            if self.T_count <= 1:
                break
            elbo_ = float(hmm_ops.entropy_terms(
                torch.as_tensor(resp, dtype=self.dtype, device=self.device),
                torch.as_tensor(respPair, dtype=self.dtype,
                                device=self.device)))
            q_obs, elbo_lin = self.compute_q_elbo(
                resp, respPair, self.weight_mean(q), self.weight_mean(q_lat),
                self.clusters, self.M, snr="saved", post=False)
            elbo_ = elbo_ + elbo_lin + q_obs
            iteration += 1
            self.train_elbo.append(elbo_)
            self.resp_assigned.append(np.argmax(resp, axis=1))
            self.q_last, self.q_lat_last = q, q_lat
            self.resp_last, self.respPair_last = resp, respPair
            if it_limit is not None and iteration >= it_limit:
                break
            repeated = (len(self.resp_assigned) > 1
                        and self.resp_assigned[-2].shape[0]
                        == self.resp_assigned[-1].shape[0]
                        and np.all(self.resp_assigned[-2]
                                   == self.resp_assigned[-1]))
            if (np.flatnonzero(resp.sum(axis=0) == 0.0).shape[0] > 1
                    or repeated):
                break
        return np.argmax(resp, axis=1)

    def reload_model_from_labels(self, x_trains, y_trains, labels, M: int,
                                 with_warp: bool = False):
        """Supervised (re)initialisation: one cluster per label, full
        refits, HDP update, representative election
        (GPI_HDP.reload_model_from_labels, GPI_HDP.py:3952-4035)."""
        y = np.asarray(y_trains, np.float64)
        if y.ndim == 2:
            y = y[:, :, None]
        N, T, L = y.shape
        if L != self.n_outputs:
            raise ValueError(f"reload_model_from_labels: {L} leads, the "
                             f"model has {self.n_outputs}")
        labels = np.asarray(labels, np.int64)
        if M != self.M:
            for ld in range(L):
                base = self.clusters[ld][0]
                self.clusters[ld] = [base.clone() for _ in range(M)]
        self.M = M
        self.T_count = N
        self._y_all = y
        self.snr_norm = np.ones((N, L))

        resp = np.zeros((N, M))
        resp[np.arange(N), labels] = 1.0
        respPair = np.zeros((N, M, M))
        respPair[np.arange(1, N), labels[:-1], labels[1:]] = 1.0
        q = np.zeros((N, M, L))
        q_lat = np.zeros((N, M, L))
        snr = np.zeros((N, M, L))
        # every (lead, cluster) refit from the lead's first cluster, in
        # batched calls
        jobs = [(self.clusters[ld][0].clone(), ld, y[:, :, ld], resp[:, m])
                for ld in range(L) for m in range(M)]
        for j, (q_col, ql_col, s_col, cl) in enumerate(
                self._full_refit_batch(jobs)):
            ld, m = divmod(j, M)
            q[:, m, ld] = q_col
            q_lat[:, m, ld] = ql_col
            snr[:, m, ld] = s_col
            self.clusters[ld][m] = cl

        resp, respPair, _end = self._refill(resp, respPair)
        self._hdp_global_update(resp, respPair, M, n_iters=2)
        self.resp_assigned.append(np.argmax(resp, axis=1))
        self.q_last, self.q_lat_last = q, q_lat
        self.resp_last, self.respPair_last = resp, respPair
        self.snr_norm = self.normalize_snr(snr)
        q_w = self.weight_mean(q, snr)
        self.f_ind_old = np.zeros(M, np.int64)
        for m in range(M):
            idx = self.clusters[0][m].members
            if idx.size:
                self.f_ind_old[m] = idx[int(np.argmax(q_w[idx, m]))]
        elbo_ = float(hmm_ops.entropy_terms(self._f64(resp),
                                            self._f64(respPair)))
        q_obs, elbo_lin = self.compute_q_elbo(
            resp, respPair, self.weight_mean(q), self.weight_mean(q_lat),
            self.clusters, self.M, snr="saved", post=False)
        elbo_ = elbo_ + elbo_lin + q_obs
        print(f"\n-------ELBO:{elbo_}-------")
        self.elbo_last = elbo_
        self.train_elbo.append(elbo_)
        return self

    # ------------------------------------------------------------------
    # Checkpoints (save_swgp, GPI_HDP.py:3946-3950): hdpgpc_tpu's npz
    # format 2, readable and writable by both packages
    # ------------------------------------------------------------------

    _CACHE_KEYS = ("q_last", "q_lat_last", "resp_last", "respPair_last")

    def save_swgp(self, path: str) -> None:
        """Checkpoint the model as an npz archive of raw arrays and a JSON
        metadata blob (format 2 of hdpgpc_tpu): no pickled objects, so
        loading a checkpoint cannot execute code. Cluster states are
        stored per leaf as ``st_{lead}_{cluster}_{i}`` in
        ``jax.tree.leaves`` order."""
        arrays: Dict[str, np.ndarray] = {
            "x_basis": self.x_basis,
            "snr_norm": np.asarray(self.snr_norm),
            "f_ind_old": np.asarray(self.f_ind_old),
            "glob_rho": np.asarray(self.glob.rho),
            "glob_omega": np.asarray(self.glob.omega),
            "glob_trans_theta": np.asarray(self.glob.trans_theta),
            "glob_start_theta": np.asarray(self.glob.start_theta),
        }
        fitted = []
        for ld, row in enumerate(self.clusters):
            fitted.append([bool(cl.fitted) for cl in row])
            for m, cl in enumerate(row):
                for i, leaf in enumerate(convert.tree_leaves(cl.state)):
                    arrays[f"st_{ld}_{m}_{i}"] = leaf.detach().cpu().numpy()
                arrays[f"members_{ld}_{m}"] = cl.members
        for k in self._CACHE_KEYS:
            v = getattr(self, k)
            if v is not None:
                arrays[f"cache_{k}"] = np.asarray(v)
        if self.resp_assigned:
            arrays["resp_assigned_last"] = np.asarray(self.resp_assigned[-1])
        meta = {
            "format": 2,
            "y_scale": float(self._y_scale),
            "cfg": self.cfg.to_json(),
            "M": int(self.M),
            "T_count": int(self.T_count),
            "train_elbo": [float(e) for e in self.train_elbo],
            "elbo_last": (None if self.elbo_last is None
                          else float(self.elbo_last)),
            "fitted": fitted,
            "glob_scalars": [float(self.glob.gamma),
                             float(self.glob.trans_alpha),
                             float(self.glob.start_alpha),
                             float(self.glob.kappa)],
        }
        with open(path, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **arrays)

    @staticmethod
    def load_swgp(path: str, device=DEFAULT_DEVICE) -> "HDPGPC":
        """Load an npz checkpoint (format 2, written by either package)
        onto ``device``; each state leaf takes the model's dtype for it.
        Loading executes no code. hdpgpc_tpu's legacy round-1 pickle
        checkpoints hold JAX arrays and hdpgpc_tpu classes, so they
        raise here."""
        dev = resolve_device(device)
        if not zipfile.is_zipfile(path):
            raise ValueError(
                f"{path} is not an npz checkpoint (format 2). A legacy "
                "round-1 pickle checkpoint of hdpgpc_tpu holds JAX arrays "
                "and hdpgpc_tpu classes and is not read by hdpgpc_torch: "
                "load it with hdpgpc_tpu's HDPGPC.load_swgp and save it "
                "again, which writes format 2.")
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            model = HDPGPC(z["x_basis"],
                           config=ModelConfig.from_json(meta["cfg"]),
                           device=dev)
            model.M = meta["M"]
            model.glob = sb.HDPGlobals(
                z["glob_rho"], z["glob_omega"], z["glob_trans_theta"],
                z["glob_start_theta"], *meta["glob_scalars"])
            proto = model._new_cluster().state
            n_leaves = len(convert.tree_leaves(proto))
            model.clusters = [
                [Cluster(convert.tree_unflatten(
                    proto, [z[f"st_{ld}_{m}_{i}"] for i in range(n_leaves)],
                    dev), fitted, z[f"members_{ld}_{m}"])
                 for m, fitted in enumerate(fit_row)]
                for ld, fit_row in enumerate(meta["fitted"])]
            model.snr_norm = z["snr_norm"]
            model.f_ind_old = z["f_ind_old"]
            model.T_count = meta["T_count"]
            model._y_scale = float(meta.get("y_scale", 1.0))
            model.train_elbo = list(meta["train_elbo"])
            model.elbo_last = meta["elbo_last"]
            if "resp_assigned_last" in z:
                model.resp_assigned = [z["resp_assigned_last"]]
            for k in HDPGPC._CACHE_KEYS:
                if f"cache_{k}" in z:
                    setattr(model, k, z[f"cache_{k}"])
        return model


def _install_timers():
    """Wrap the orchestrator's phases with wall timers, on per instance
    with HDPGPC_TIMING=1: hdpgpc_tpu's nine methods under its eight keys
    (the port has no ``_fb``; its online FB, ``_vlt_online``, is timed as
    ``fb`` with ``_fb_hard``). A phase is charged its own time only: the
    time of a timed phase it calls goes to that phase, so the timings
    sum to no more than the wall time; a phase called inside itself
    counts once. On a card the clock is read after a device
    synchronise, so a phase is charged its device work, not the
    launching of it. Whatever the timers, each call is also a span of
    the recorder (utils/metrics) under the timer's key, recorded while
    the recorder is on; the span itself never synchronises."""

    def timed(name):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(self, *a, **k):
                with span(name):
                    if not getattr(self, "_timing_on", False) or any(
                            f[0] == name for f in self._timing_stack):
                        return fn(self, *a, **k)
                    stack = self._timing_stack
                    cuda = self.device.type == "cuda"
                    if cuda:
                        torch.cuda.synchronize(self.device)
                    frame = [name, 0.0]
                    stack.append(frame)
                    t0 = time.perf_counter()
                    try:
                        return fn(self, *a, **k)
                    finally:
                        if cuda:
                            torch.cuda.synchronize(self.device)
                        dt = time.perf_counter() - t0
                        stack.pop()
                        self.timings[name] = (self.timings.get(name, 0.0)
                                              + dt - frame[1])
                        self.counts[name] = self.counts.get(name, 0) + 1
                        if stack:
                            stack[-1][1] += dt
            return wrapper
        return deco

    HDPGPC._full_refit_batch = timed("refit_batch")(HDPGPC._full_refit_batch)
    HDPGPC._full_refit = timed("refit_one")(HDPGPC._full_refit)
    HDPGPC._seed_score = timed("seed_score")(HDPGPC._seed_score)
    HDPGPC._vlt_online = timed("fb")(HDPGPC._vlt_online)
    HDPGPC._fb_hard = timed("fb")(HDPGPC._fb_hard)
    HDPGPC._maybe_kernel_fit = timed("kernel_fit")(HDPGPC._maybe_kernel_fit)
    HDPGPC.compute_q_elbo = timed("q_elbo")(HDPGPC.compute_q_elbo)
    HDPGPC._hdp_global_update = timed("hdp_update")(
        HDPGPC._hdp_global_update)
    HDPGPC._warp_by_resp = timed("warp")(HDPGPC._warp_by_resp)


_install_timers()
