"""Smoke run of hdpgpc_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases build,kernels

Phases (each prints a line; any failure raises and exits non-zero):

1. device: find the card (raise without one) and print
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
2. build: compile both kernels from hdpgpc_torch/csrc with nvcc (one
   process per source, in parallel) and print the build seconds and the
   registers / shared memory that ``-Xptxas -v`` reports per kernel;
3. kernels: kernel B against its plain PyTorch version and a float64
   truth at (16, 90, 90), (8, 128, 128), (4, 200, 200) and
   (2, 300, 300), kernel A (with the noise fused in) against its plain
   version at T = 90 and 256, both dtypes; at the refit's shapes each
   kernel's eager time (``ms``), its device time from a replayed CUDA
   graph (``device_ms``), the plain version's time, one
   ``torch.linalg.solve`` call's (kernel B's ``library_ms``) and the
   bound from the shapes (``hdpgpc_torch/utils/kernel_timing.py``);
   kernel A on (T, D) grids at (90, 3) and (256, 2), both dtypes, the
   first timed;
4. slice: ``HDPGPC.include_batch`` on 2272 synthetic beats of T = 90
   (record 100's shape), float32, estimation_limit=1000, on the card,
   with launch counts of both kernels from that run alone;
5. parity: the same sweep in float64 on the first 200 beats, on the
   card (kernels) and on the CPU (plain versions): identical partitions
   in every sweep, equal M, ELBO equal to 1e-8 relative;
6. online: the fused stream engine (models/stream_online.py) at
   bench.py's online settings (K = 16 slots, chunk 32, float32, HDP
   refresh per chunk) on 800 beats of the growth stream
   (one new morphology every 200 beats), the first 96 beats an untimed
   warm-up: beats/s, M, births, the majority-label error against the
   generating labels, and each kernel's launches in the timed part;
7. online_parity: the engine in float64 at chunk 1 on the first 230
   beats (the first birth is at beat 200), and include_sample_fast on
   the first 100, each on the card and on the CPU: identical partitions
   and M, the engine's accounting sums equal to 1e-8 relative;
8. growth: the growth stress (BASELINE config 5's ``--grow`` half,
   examples/torch_run_stress_stream.py) through the fused engine at
   K = 64 slots, T = 90, float32, estimation_limit=100, on 2048 beats of
   the growth stream with 8 morphologies (one new every 256 beats), the
   first 256 untimed: beats/s, ms per steady beat, births, the seconds
   of the kernel fits, kernel-B launches per beat, peak memory; the gates
   of tests/test_stress_growth.py (births after the first quarter,
   M >= 6, M <= 64, the carry's bytes constant, majority-label accuracy
   >= 0.85) and finite accounting;
9. warp: ``include_batch(with_warp=True)`` on 2272 synthetic beats of
   T = 90 and TWO leads (record 102's shape, BASELINE config 3), float32,
   estimation_limit=1000, two sweeps, the warp noise from the data as
   examples/run_offline.py takes it: s/sweep, M, error, the batched warps
   run and the warp-cache hits, the seconds of one batched warp
   (B = 2272, 50 Adam steps) timed alone, each kernel's launches;
10. warp_parity: that sweep in float64 on the first 200 beats, two
    sweeps, card against CPU: identical partitions in every sweep, ELBO
    to 1e-8;
11. online_warp: include_sample_fast in float64 on a growth stream,
    card against CPU: 44 beats without the warp (the stream's first
    birth is at beat 40; under the warp these beats are absorbed), then
    24 with it (greedy, 250 Adam steps a warp): identical decisions;
    s/beat and warps a beat of the warped part;
12. ml_em: the offline sweep with bayesian_params=False (the ML-EM
    refit) in float64 on the first 200 beats of the slice, card against
    CPU: identical partitions; the card's s/sweep and kernel B launches;
13. reload: the supervised path on the warp phase's beats (2272 x 2
    leads, float32): reload_model_from_labels on the first 2000 with
    their labels, then cluster_new_batch on the other 272 without and
    with learning (it_limit=2): seconds, accuracy, M and launches of
    each; then the same on the first 180 beats (150 + 30) in float64,
    card against CPU: identical labels, ELBO to 1e-9;
14. checkpoint: save_swgp of the reload model, load_swgp on the card and
    on the CPU: identical cluster_new_batch labels from all three; the
    file's bytes, save and load seconds;
15. stream: the frozen-cluster classifier (models/streaming.py) at
    BASELINE config 5's width (K = 64, T = 90, float32, templates from
    a 50 K-beat warm-up), the chunk sized from the free device memory:
    one untimed chunk, then 65,536 beats timed: beats/s, ms a chunk,
    kernel-B launches a chunk, peak memory, the idle share of one
    profiled chunk, accuracy >= 0.95, counts summing to the beats
    streamed, finite states; kernel B timed at the classifier's two
    shapes; then 2,048 beats at K = 8 in float64, card against CPU:
    identical labels, f and P to 1e-9;
16. inducing: fit_kernel_sgpr and fit_kernel_svgp on a beat of T = 90
    in float64, card against CPU (at capped iterations, as the CPU tests
    hold them against hdpgpc_tpu), one full SGPR fit timed on the card;
    include_batch with inducing_points=True on 200 beats in float64 for
    two sweeps, card against CPU: identical partitions;
17. records: the multi-record VI step (parallel/records.py) at BASELINE
    config 4's shape on one card: 48 synthetic records of 2272 beats
    (record r from seed r), K = 4, T = 90, float32, the slice's
    estimation limit, hard responsibilities from the generating labels,
    hdp_update: one untimed step, one timed: s/step, beats/s, the record
    group and the groups a step, kernel B's launches a step and their
    shape, kernel A's launches, peak memory, the idle share of a
    profiled one-group step over the first 128 beats; the ELBO finite
    and equal to the sum of the per-record ELBOs; kernel B timed at a
    group's (4 G K, 90, 90) and all records' (4 R K, 90, 90);
18. records_parity: 4 records of 200 beats, K = 3, float64, hdp_update
    off and on, card against CPU (identical resp and respPair, q, q_lat,
    the ELBO and the states to 1e-9), the step through a one-rank NCCL
    group against the step without one (identical), and entry() once;
19. timing: the slice's configuration on its first 300 beats with
    HDPGPC_TIMING=1 against the same sweep without: identical
    partitions, the timer keys within hdpgpc_tpu's eight, the timings
    summing to no more than the sweep's wall time; print_timings.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Logs of the sweeps go to
``chiprun_out/`` beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "slice", "parity", "online",
          "online_parity", "growth", "warp", "warp_parity", "online_warp", "ml_em",
          "reload", "checkpoint", "stream", "inducing", "records",
          "records_parity", "timing")
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# kernel B: max |X - X64| / (|X64| + 1e-3) against a float64 truth
SOLVE_BAR = {"float64": 1e-10, "float32": 2e-3}
# kernel A: max |K - K_plain| / (|K_plain| + 1e-30 * c)
GRAM_BAR = {"float64": 1e-13, "float32": 1e-6}
# kernel A on (T, D) grids (T, D), the first timed
GRAM_ND_SHAPES = ((90, 3), (256, 2))
SLICE_EST_LIMIT = 1000
# the offline parity prefix: the first 200 beats reach the same M = 4 as
# 300 in about 2/3 of the time
PARITY_BEATS = 200
# kernel B's check shapes (n, T), R = T: the refit's (4 J <= 16, 90);
# the stream engine's absorb candidates (4 K, 90) at K = 16 and at the
# growth stress's K = 64, its commit (4, 90) and birth (2, 90); and
# above what the unblocked kernel of the first slice took (T > 128)
SOLVE_SHAPES = ((16, 90), (64, 90), (256, 90), (4, 90), (2, 90), (8, 128),
                (4, 200), (2, 300))
# of these, the shapes the main paths launch, timed
SOLVE_TIMED = ((16, 90), (64, 90), (256, 90), (4, 90), (2, 90))
# the online phases: bench.py's engine settings on the growth stream
GROWTH = dict(n=800, T=90, n_clusters=4, seed=7, start_beat=0,
              interval=200)
ONLINE_K, ONLINE_CHUNK, ONLINE_WARM = 16, 32, 96
ONLINE_MAX_ERR = 0.02
PARITY_ENGINE_BEATS, PARITY_FAST_BEATS = 230, 100
# the growth stress: examples/torch_run_stress_stream.py --grow's model
# and engine at K = 64 slots on a shorter stream, in the regime of
# tests/test_stress_growth.py: 8 morphologies, the priors' 256 beats
# holding one of them (as the example's warm-up does at its interval of
# beats // K). On 12 morphologies the birth rule absorbs some as
# near-duplicates (M 7 of 12 at an interval of 128; 40 of 64 in
# docs/STRESS.md's run), below that test's M >= morphologies - 2
# (tools/torch_growth_regimes.py). The engine refreshes the HDP globals
# at the end of each run() call and every GROWTH_CHUNK beats in it (the
# example's min(--chunk, 1024)); the first GROWTH_WARM beats are
# untimed, and M and the carry's bytes are read at the quarter (its own
# run() call, so one more refresh there)
GROWTH_STREAM = dict(n=2048, T=90, n_clusters=8, seed=7, start_beat=0,
                     interval=256)
GROWTH_K, GROWTH_CHUNK, GROWTH_WARM, GROWTH_EST = 64, 1024, 256, 100
GROWTH_MIN_ACC = 0.85
# the warp phases: the slice's beats with two leads, two sweeps; the
# float64 parity prefix runs two (to convergence it takes nine, M 8,
# ~8 minutes of CPU on its half alone)
WARP_LEADS, WARP_SWEEPS, WARP_PARITY_BEATS = 2, 2, 200
WARP_PARITY_SWEEPS = 2
# the online warp: under the warp the growth stream's new morphologies
# are absorbed (no birth in 46 beats at interval 40, hdpgpc_tpu and the
# port alike, on a CPU), so the stream's first ONLINE_WARP_FREE beats run
# without it and hold its first birth (beat 40); ONLINE_WARP_BEATS
# warped beats follow
ONLINE_WARP = dict(n=256, T=90, n_clusters=4, seed=7, start_beat=0,
                   interval=40)
ONLINE_WARP_FREE, ONLINE_WARP_BEATS = 44, 24
ML_EM_BEATS = 200
# the supervised path: labelled beats, new beats; its float64 parity
RELOAD_TRAIN, RELOAD_LEARN_SWEEPS = 2000, 2
RELOAD_PARITY_TRAIN, RELOAD_PARITY_NEW = 150, 30
# the frozen-cluster classifier: BASELINE config 5 (docs/STRESS.md) and
# examples/run_stress_stream.py's templates and priors; the timed beats
# are one generation block of that run's 1M beats
STREAM_K, STREAM_T, STREAM_TIMED = 64, 90, 65536
STREAM_PRIORS = dict(ini_gamma=0.001, ini_sigma=0.05)
STREAM_MIN_ACC = 0.95
STREAM_PARITY_K, STREAM_PARITY_BEATS, STREAM_PARITY_CHUNK = 8, 2048, 512
# the inducing phase: the fits held card against CPU at the iteration
# counts of tests/test_torch_kernel_fit_inducing.py (past them rounding
# decides steps that start at zero gradients); the sweep's inducing fits
# capped at 300 Adam iterations (5000 by default: ~10 fits a sweep, each
# 5000 iterations, would take minutes of CPU on its half)
INDUCING_FIT_ITERS = {"sgpr": 200, "svgp": 20}
INDUCING_BEATS, INDUCING_SWEEPS, INDUCING_SWEEP_ITERS = 200, 2, 300
# the multi-record step: BASELINE config 4's shape (48 records of record
# 100's length, the slice's beats and estimation limit) on one card,
# float32; its parity on 4 records of 200 beats in float64, card against
# CPU
RECORDS_R, RECORDS_N, RECORDS_K, RECORDS_TIMED = 48, 2272, 4, 1
RECORDS_PROFILED = 128
# the beats of the one-group step that measures the refit's peak at
# est_limit None (each of its slots is sequential)
RECORDS_NO_LIMIT_BEATS = 1024
RECORDS_HDP = dict(trans_alpha=1.0, start_alpha=0.1, kappa=0.0)
RECORDS_PARITY = dict(R=4, N=200, K=3)


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    _say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return line


def phase_build():
    from hdpgpc_torch.ops import _build
    for p in _build.sources():
        _say("build", f"source {os.path.relpath(p, ROOT)}")
    _build.load()
    info = _build.BUILD_INFO
    _say("build", f"nvcc {info['seconds']:.2f} s -> " + ", ".join(
        os.path.relpath(p, ROOT) for p in info["paths"]))
    fn = None
    for ln in str(info["ptxas"]).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", ln)
        if m and fn:
            _say("build", f"{fn}: {m.group(1)} registers, {m.group(2)} "
                 "bytes static smem")
        elif "Used" in ln and fn:
            _say("build", f"{fn}: {ln.strip()}")
    return info


def _spd_inputs(np, n, T, seed, cond):
    """SPD stacks at the Kalman magnitudes of tests/test_pallas_chol.py
    (x37 matrices, x12 right-hand sides) with ``cond`` on the diagonal."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, T, T))
    spd = (M @ M.transpose(0, 2, 1) + cond * np.eye(T)) * 37.0
    rhs = rng.standard_normal((n, T, T)) * 12.0
    return spd, rhs


def _truth(np, A, B):
    """float64 solve refined twice with extended-precision residuals,
    so the reference's own rounding does not count against a kernel."""
    x = np.linalg.solve(A, B)
    ld = np.longdouble
    for _ in range(2):
        r = B.astype(ld) - np.matmul(A.astype(ld), x.astype(ld))
        x = x + np.linalg.solve(A, r.astype(np.float64))
    return x


def _timings(fn, plain, library, bound):
    from hdpgpc_torch.utils.kernel_timing import device_ms, events_ms
    bms, by = bound
    return dict(ms=events_ms(fn), device_ms=device_ms(fn),
                device_ms_method="cuda_graph",
                plain_ms=events_ms(plain),
                library_ms=None if library is None else events_ms(library),
                bound_ms=bms, bound_by=by)


def phase_kernels(torch, np):
    from hdpgpc_torch.ops.kernels import KernelParams, gram, rbf_gram_noise
    from hdpgpc_torch.ops.spd_solve import spd_solve, spd_solve_plain
    from hdpgpc_torch.utils.kernel_timing import (rbf_gram_bound,
                                                  spd_solve_bound)
    dev = torch.device("cuda")
    rec = {}
    # ---- kernel B ----
    # cond=5.0: the well-conditioned systems of the bar at
    # tests/test_pallas_chol.py:29-47 (kernel must meet SOLVE_BAR);
    # cond=0.05: the near-singular ones of :50-64, where no Cholesky
    # solve meets those bars (the plain one neither), so the kernel is
    # held to twice the plain version's error there. T = 200 and 300 go
    # through the kernel's scratch-buffer path (the factor does not fit
    # in shared memory)
    for cond in (5.0, 0.05):
        for (n, T) in SOLVE_SHAPES:
            spd64, rhs64 = _spd_inputs(np, n, T, n + T, cond)
            for dname, ndt in (("float64", np.float64),
                               ("float32", np.float32)):
                spd_h, rhs_h = spd64.astype(ndt), rhs64.astype(ndt)
                truth = _truth(np, spd_h.astype(np.float64),
                               rhs_h.astype(np.float64))
                spd = torch.as_tensor(spd_h, device=dev)
                rhs = torch.as_tensor(rhs_h, device=dev)
                X = spd_solve(spd, rhs)
                torch.cuda.synchronize()
                Xp = spd_solve_plain(spd, rhs)
                torch.cuda.synchronize()
                Xn = X.double().cpu().numpy()
                Xpn = Xp.double().cpu().numpy()
                err = float(np.max(np.abs(Xn - truth)
                                   / (np.abs(truth) + 1e-3)))
                err_p = float(np.max(np.abs(Xpn - truth)
                                     / (np.abs(truth) + 1e-3)))
                dkp = float(np.max(np.abs(Xn - Xpn)))
                bar = SOLVE_BAR[dname] if cond == 5.0 \
                    else max(2.0 * err_p, SOLVE_BAR[dname])
                _say("kernels", f"spd_solve ({n},{T},{T}) {dname} cond "
                     f"{cond}: kernel err {err:.3e}, plain err {err_p:.3e} "
                     f"(bar {bar:.1e}); max|kernel-plain| {dkp:.3e}")
                if not (math.isfinite(err) and err < bar):
                    raise AssertionError(
                        f"spd_solve {dname} ({n},{T}) cond {cond} err {err}")
                if (n, T) in SOLVE_TIMED and cond == 5.0:
                    t = _timings(
                        lambda: spd_solve(spd, rhs),
                        lambda: spd_solve_plain(spd, rhs),
                        lambda: torch.linalg.solve(spd, rhs),
                        spd_solve_bound(n, T, T, spd.dtype))
                    _say("kernels", f"spd_solve ({n},{T},{T}) {dname}: " +
                         _fmt_times(t))
                    key = "spd_solve" if (n, T) == (16, 90) \
                        else f"spd_solve_{n}x{T}x{T}"
                    rec[f"{key}_{dname}"] = dict(max_abs_err=dkp, **t)
    # ---- kernel A: gram with the noise on the diagonal, one launch ----
    for T in (90, 256):
        for dname, dt in (("float64", torch.float64),
                          ("float32", torch.float32)):
            x = torch.arange(T, dtype=dt, device=dev)
            p = KernelParams(*[torch.tensor(v, dtype=dt, device=dev)
                               for v in (300.0, 1.2, 0.05)])
            K = gram(p, x)
            torch.cuda.synchronize()
            Kp = rbf_gram_noise(x, x, *p)
            torch.cuda.synchronize()
            Kd, Kpd = K.double(), Kp.double()
            rel = float(((Kd - Kpd).abs() / (Kpd.abs() + 1e-30 * 300.0))
                        .max())
            dkp = float((Kd - Kpd).abs().max())
            _say("kernels", f"gram (rbf_gram + noise) T={T} {dname}: max "
                 f"rel err vs plain {rel:.3e} (bar {GRAM_BAR[dname]:.0e}), "
                 f"max abs {dkp:.3e}")
            if not rel <= GRAM_BAR[dname]:
                raise AssertionError(f"rbf_gram {dname} T={T} rel {rel}")
            if T == 90:
                t = _timings(lambda: gram(p, x),
                             lambda: rbf_gram_noise(x, x, *p), None,
                             rbf_gram_bound(T, T, dt))
                _say("kernels", f"gram T=90 {dname}: " + _fmt_times(t))
                rec[f"rbf_gram_{dname}"] = dict(max_abs_err=dkp, **t)
            # a (T, 1) grid is the flat grid: the same launch, same bits
            if not torch.equal(gram(p, x[:, None]), K):
                raise AssertionError(f"rbf_gram {dname} T={T}: the (T, 1) "
                                     "grid differs from the flat one")
    # ---- kernel A on (T, D) grids: the distance summed over D ----
    for (T, D) in GRAM_ND_SHAPES:
        for dname, dt in (("float64", torch.float64),
                          ("float32", torch.float32)):
            x = torch.as_tensor(np.random.default_rng(T + D).uniform(
                0.0, 6.0, (T, D)), dtype=dt, device=dev)
            p = KernelParams(*[torch.tensor(v, dtype=dt, device=dev)
                               for v in (300.0, 1.2, 0.05)])
            K = gram(p, x)
            Kp = rbf_gram_noise(x, x, *p)
            torch.cuda.synchronize()
            Kd, Kpd = K.double(), Kp.double()
            rel = _gram_nd_rel(torch, x, Kd, Kpd, 300.0, 1.2)
            dkp = float((Kd - Kpd).abs().max())
            _say("kernels", f"gram (rbf_gram + noise) ({T}, {D}) grid "
                 f"{dname}: max rel err vs plain over 1 + |exponent| "
                 f"{rel:.3e} (bar {GRAM_BAR[dname]:.0e}), max abs "
                 f"{dkp:.3e}")
            if not rel <= GRAM_BAR[dname]:
                raise AssertionError(f"rbf_gram {dname} ({T}, {D}) rel {rel}")
            if T == 90:
                t = _timings(lambda: gram(p, x),
                             lambda: rbf_gram_noise(x, x, *p), None,
                             rbf_gram_bound(T, T, dt, D))
                _say("kernels", f"gram ({T}, {D}) grid {dname}: "
                     + _fmt_times(t))
                rec[f"rbf_gram_{T}x{D}_{dname}"] = dict(max_abs_err=dkp, **t)
    return rec


def _gram_nd_rel(torch, x, K, Kp, c, ls):
    """max |K - K_plain| / ((|K_plain| + 1e-30 c) (1 + |z|)), z the
    exponent -0.5 |xi - xj|^2 / l^2. Over D > 1 the kernel and the plain
    version may sum the squares in another order; one rounding of the
    sum moves exp(z) by |z| roundings, so the bar is scaled by the
    exponent's condition number."""
    xd = x.double()
    z = 0.5 * torch.cdist(xd, xd) ** 2 / ls ** 2
    return float(((K - Kp).abs() / ((Kp.abs() + 1e-30 * c) * (1.0 + z)))
                 .max())


def _fmt_times(t):
    lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    return (f"kernel {t['ms']:.4f} ms eager, {t['device_ms']:.4f} ms on "
            f"the device ({t['device_ms_method']}), plain "
            f"{t['plain_ms']:.4f} ms, library {lib}, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']})")


def _model(HDPGPC, y, est, dtype, device, **kw):
    from hdpgpc_torch.data.loader import default_x_basis
    from hdpgpc_torch.data.priors import compute_estimators_lds
    std, std_dif, bs, bg = compute_estimators_lds(y)
    # the benched configuration of bench.py:58-68, except
    # reestimate_initial_params: its estimator reads the first 10
    # samples of each beat as an ECG baseline (GPI_HDP.py:1876-1880),
    # which synthetic beats do not have; with it, hdpgpc_tpu and this
    # port alike keep one cluster on these beats
    cfg = dict(ini_lengthscale=3.0, bound_lengthscale=(1.0, 20.0),
               ini_gamma=std_dif, ini_sigma=std, ini_outputscale=300.0,
               bound_sigma=bs, bound_gamma=bg, verbose=False,
               hmm_switch=True, max_models=100, bayesian_params=True,
               reestimate_initial_params=False, n_explore_steps=5,
               free_deg_MNIV=5, estimation_limit=est,
               compute_dtype=dtype, device=device)
    cfg.update(kw)
    return HDPGPC(default_x_basis(y.shape[1]), n_outputs=y.shape[2], **cfg)


def _warp_model(HDPGPC, y, est, dtype, device):
    """_model with the warp noise taken from the data as
    examples/run_offline.py:33-43 takes it."""
    from hdpgpc_torch.data.priors import compute_estimators_lds
    noise_warp = compute_estimators_lds(y)[0] * 0.1
    return _model(HDPGPC, y, est, dtype, device, noise_warp=noise_warp,
                  bound_noise_warp=(noise_warp * 0.1, noise_warp * 0.2),
                  method_compute_warp="greedy")


def _quiet(fn, log_name):
    """Run ``fn`` with its printing sent to ``chiprun_out/<log_name>``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, log_name), "w") as f:
        f.write(buf.getvalue())
    return out


def _counted(fn):
    """Run ``fn`` with both kernels' launch counts set to 0 just before;
    returns fn's result and the counts just after."""
    from hdpgpc_torch.ops.kernels import fused_rbf_gram
    from hdpgpc_torch.ops.spd_solve import spd_solve
    spd_solve.launches = 0
    fused_rbf_gram.launches = 0
    out = fn()
    return out, {"spd_solve": spd_solve.launches,
                 "rbf_gram": fused_rbf_gram.launches}


def _sweep(torch, np, model, y, log_name, with_warp=False, it_limit=None):
    x = np.tile(np.arange(y.shape[1], dtype=np.float64), (y.shape[0], 1))
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _quiet(lambda: model.include_batch(x, y, it_limit=it_limit,
                                       with_warp=with_warp), log_name)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_slice(torch, np):
    from hdpgpc_torch.data.loader import synthetic_beats
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.utils.eval import classification_error
    y, z = synthetic_beats(2272, T=90, n_clusters=4, noise=0.05, seed=0)
    # estimation_limit: at 300 the births stop at M=2 on these beats
    # (1160/2272 wrong), in hdpgpc_tpu on the CPU in float32 and float64
    # as in this port; at 1000 both find the 4 generating clusters with
    # identical partitions, as the repo's est-limit policy (raise the
    # limit on an est-divergent record) prescribes
    model = _model(HDPGPC, y, SLICE_EST_LIMIT, "float32", "cuda")
    secs, launches = _counted(
        lambda: _sweep(torch, np, model, y, "chip_smoke_slice.log"))
    sweeps = len(model.train_elbo)
    err, tot = classification_error(model, z)
    elbo = model.train_elbo[-1] if sweeps else float("nan")
    _say("slice", f"sweeps {sweeps}, M {model.M}, {secs:.2f} s total, "
         f"{secs / max(sweeps, 1):.3f} s/sweep, error {err}/{tot}, "
         f"f32_fragile {model.f32_fragile}, final ELBO {elbo:.6f}, "
         f"launches {launches}, refit memo hits/misses "
         f"{model._memo_stats}")
    if not (sweeps and all(math.isfinite(e) for e in model.train_elbo)):
        raise AssertionError("non-finite or missing ELBO")
    if err > 0.02 * tot:
        raise AssertionError(f"classification error {err}/{tot} > 2%")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


def phase_parity(torch, np):
    from hdpgpc_torch.data.loader import synthetic_beats
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    y, _z = synthetic_beats(2272, T=90, n_clusters=4, noise=0.05, seed=0)
    y = y[:PARITY_BEATS]
    runs = {}
    for dev in ("cuda", "cpu"):
        m = _model(HDPGPC, y, 300, "float64", dev)
        secs, lc = _counted(lambda: _sweep(torch, np, m, y,
                                           f"chip_smoke_parity_{dev}.log"))
        runs[dev] = m
        _say("parity", f"{dev}: sweeps {len(m.train_elbo)}, M {m.M}, "
             f"{secs:.2f} s, launches {lc}")
    a, b = runs["cuda"], runs["cpu"]
    same, rel = _same_sweeps(np, a, b)
    _say("parity", f"identical partitions {same}, M {a.M} vs {b.M}, "
         f"max ELBO rel diff {rel:.3e}")
    if not (same and rel <= 1e-8):
        raise AssertionError("card and CPU sweeps disagree")


def _growth_model(HDPGPC, y, dtype, device, K=ONLINE_K, est=50):
    """The growth stress configuration (tests/test_stress_growth.py,
    examples/run_stress_stream.py:68-82): priors from the stream's first
    256 beats, estimation_limit ``est``, at most K clusters."""
    import numpy as np
    from hdpgpc_torch.data.loader import default_x_basis
    w = y[:256]
    std = float(np.std(w))
    sd = float(np.std(np.diff(w, axis=0)))
    return HDPGPC(default_x_basis(y.shape[1]), n_outputs=1,
                  ini_lengthscale=3.0, bound_lengthscale=(1.0, 20.0),
                  ini_gamma=sd, ini_sigma=std, ini_outputscale=4.0,
                  bound_sigma=(std * 0.05, std * 0.2),
                  bound_gamma=(sd * 0.05, sd * 0.2), verbose=False,
                  hmm_switch=True, max_models=K,
                  bayesian_params=True, estimation_limit=est,
                  free_deg_MNIV=5, compute_dtype=dtype, device=device)


def _majority_error(np, labels, z):
    return int(sum(np.sum(labels == c) - np.bincount(z[labels == c]).max()
                   for c in np.unique(labels)))


def phase_online(torch, np):
    from hdpgpc_torch.data.loader import synthetic_growth_stream
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.models.stream_online import OnlineStreamEngine
    y, z = synthetic_growth_stream(**GROWTH)
    eng = OnlineStreamEngine(_growth_model(HDPGPC, y, "float32", "cuda"),
                             K=ONLINE_K, chunk=ONLINE_CHUNK)
    _quiet(lambda: eng.run(y[:ONLINE_WARM]), "chip_smoke_online_warm.log")
    torch.cuda.synchronize()

    def timed():
        t0 = time.perf_counter()
        _quiet(lambda: eng.run(y[ONLINE_WARM:]), "chip_smoke_online.log")
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    secs, launches = _counted(timed)
    timed = y.shape[0] - ONLINE_WARM
    err = _majority_error(np, eng.labels(), z)
    M = int(eng.carry.M)
    sums = (float(eng.carry.q_sel_sum), float(eng.carry.qlat_sel_sum))
    _say("online", f"{timed} beats timed in {secs:.3f} s: "
         f"{timed / secs:.2f} beats/s; M {M}, births {sum(eng.births)}, "
         f"error {err}/{y.shape[0]}, q_sel_sum {sums[0]:.6f}, "
         f"qlat_sel_sum {sums[1]:.6f}, launches {launches} "
         f"({launches['spd_solve'] / timed:.3f} kernel B per beat)")
    if err > ONLINE_MAX_ERR * y.shape[0]:
        raise AssertionError(f"online error {err}/{y.shape[0]} > 2%")
    if M < 2:
        raise AssertionError("no birth on the card (M < 2)")
    if not all(math.isfinite(v) for v in sums):
        raise AssertionError(f"non-finite accounting {sums}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


def phase_online_parity(torch, np):
    from hdpgpc_torch.data.loader import synthetic_growth_stream
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.models.stream_online import OnlineStreamEngine
    y, _z = synthetic_growth_stream(**GROWTH)
    eng = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        e = OnlineStreamEngine(_growth_model(HDPGPC, y, "float64", dev),
                               K=ONLINE_K, chunk=1)
        _, lc = _counted(lambda: _quiet(
            lambda: e.run(y[:PARITY_ENGINE_BEATS]),
            f"chip_smoke_online_parity_engine_{dev}.log"))
        eng[dev] = e
        _say("online_parity", f"engine {dev}: {PARITY_ENGINE_BEATS} beats "
             f"in {time.perf_counter() - t0:.2f} s, M {int(e.carry.M)}, "
             f"launches {lc}")
    a, b = eng["cuda"], eng["cpu"]
    rel = max(abs(float(getattr(a.carry, f)) - float(getattr(b.carry, f)))
              / abs(float(getattr(b.carry, f)))
              for f in ("q_sel_sum", "qlat_sel_sum"))
    same = np.array_equal(a.labels(), b.labels())
    _say("online_parity", f"engine: identical partitions {same}, M "
         f"{int(a.carry.M)} vs {int(b.carry.M)}, accounting rel diff "
         f"{rel:.3e}")
    if not (same and int(a.carry.M) == int(b.carry.M) and rel <= 1e-8):
        raise AssertionError("card and CPU engines disagree")
    x = np.arange(y.shape[1], dtype=np.float64)
    fast = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m = _growth_model(HDPGPC, y, "float64", dev)

        def stream(m=m):
            for i in range(PARITY_FAST_BEATS):
                m.include_sample_fast(x, y[i], with_warp=False)
        _, lc = _counted(lambda: _quiet(
            stream, f"chip_smoke_online_parity_fast_{dev}.log"))
        fast[dev] = m
        _say("online_parity", f"include_sample_fast {dev}: "
             f"{PARITY_FAST_BEATS} beats in "
             f"{time.perf_counter() - t0:.2f} s, M {m.M}, launches {lc}")
    a, b = fast["cuda"], fast["cpu"]
    same = (a.M == b.M and len(a.resp_assigned) == len(b.resp_assigned)
            and all(np.array_equal(p, q) for p, q in
                    zip(a.resp_assigned, b.resp_assigned)))
    _say("online_parity", f"include_sample_fast: identical partitions "
         f"{same}, M {a.M} vs {b.M}")
    if not same:
        raise AssertionError("card and CPU include_sample_fast disagree")


def _carry_bytes(carry):
    from hdpgpc_torch.convert import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(carry))


def phase_growth(torch, np):
    from hdpgpc_torch.data.loader import synthetic_growth_stream
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.models.stream_online import OnlineStreamEngine
    dev = torch.device("cuda")
    y, z = synthetic_growth_stream(**GROWTH_STREAM)
    n, quarter = y.shape[0], y.shape[0] // 4
    eng = OnlineStreamEngine(_growth_model(HDPGPC, y, "float32", "cuda",
                                           K=GROWTH_K, est=GROWTH_EST),
                             K=GROWTH_K, chunk=GROWTH_CHUNK)
    secs0 = _timed(torch, lambda: _quiet(
        lambda: eng.run(y[:GROWTH_WARM]), "chip_smoke_growth_warm.log"))[1]
    fits0, fit_s0 = eng.step.fits, eng.step.fit_seconds
    torch.cuda.reset_peak_memory_stats(dev)
    at_quarter = {}

    def timed():
        secs = _timed(torch, lambda: eng.run(y[GROWTH_WARM:quarter]))[1]
        at_quarter.update(M=int(eng.carry.M),
                          bytes=_carry_bytes(eng.carry))
        return secs + _timed(torch, lambda: eng.run(y[quarter:]))[1]
    secs, launches = _counted(lambda: _quiet(timed, "chip_smoke_growth.log"))
    peak = torch.cuda.max_memory_allocated(dev)
    timed_n = n - GROWTH_WARM
    fits, fit_s = eng.step.fits - fits0, eng.step.fit_seconds - fit_s0
    M = int(eng.carry.M)
    acc = 1.0 - _majority_error(np, eng.labels(), z) / n
    sums = (float(eng.carry.q_sel_sum), float(eng.carry.qlat_sel_sum))
    same_bytes = _carry_bytes(eng.carry) == at_quarter["bytes"]
    _say("growth", f"K {GROWTH_K} slots, T {y.shape[1]}, float32, est "
         f"{GROWTH_EST}, chunk {GROWTH_CHUNK}, {n} beats of "
         f"{GROWTH_STREAM['n_clusters']} morphologies (one every "
         f"{GROWTH_STREAM['interval']}): first {GROWTH_WARM} untimed in "
         f"{secs0:.2f} s; {timed_n} beats in {secs:.3f} s: "
         f"{timed_n / secs:.2f} beats/s, "
         f"{1e3 * (secs - fit_s) / timed_n:.2f} ms per steady beat (the "
         f"kernel fits' seconds taken out); M {at_quarter['M']} at the "
         f"quarter, {M} at the end, births {sum(eng.births)} "
         f"({sum(eng.births[GROWTH_WARM:])} timed), kernel fits {fits} "
         f"timed in {fit_s:.2f} s ({fit_s / max(fits, 1):.2f} s a fit); "
         f"launches {launches} ({launches['spd_solve'] / timed_n:.3f} "
         f"kernel B a beat); peak memory {peak / 2**30:.3f} GiB; carry "
         f"{at_quarter['bytes']} bytes at the quarter, equal at the end "
         f"{same_bytes}; majority-label accuracy {acc:.4f}; q_sel_sum "
         f"{sums[0]:.6f}, qlat_sel_sum {sums[1]:.6f}")
    if not M > at_quarter["M"] >= 1:
        raise AssertionError(f"no birth after the first quarter "
                             f"({at_quarter['M']} -> {M})")
    if not GROWTH_STREAM["n_clusters"] - 2 <= M <= GROWTH_K:
        raise AssertionError(f"M {M} outside [n_clusters - 2, K]")
    if not same_bytes:
        raise AssertionError("the carry grew after the quarter")
    if acc < GROWTH_MIN_ACC:
        raise AssertionError(f"majority accuracy {acc} < {GROWTH_MIN_ACC}")
    if not all(math.isfinite(v) for v in sums):
        raise AssertionError(f"non-finite accounting {sums}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


def _same_sweeps(np, a, b):
    """Identical partitions in every sweep, equal M, and the largest
    relative ELBO difference."""
    same = (a.M == b.M and len(a.resp_assigned) == len(b.resp_assigned)
            and all(np.array_equal(p, q) for p, q in zip(a.resp_assigned,
                                                         b.resp_assigned)))
    ea, eb = np.asarray(a.train_elbo), np.asarray(b.train_elbo)
    rel = float(np.max(np.abs(ea - eb) / np.abs(eb))) \
        if ea.shape == eb.shape and ea.size else float("inf")
    return same, rel


def _warp_beats():
    from hdpgpc_torch.data.loader import synthetic_beats
    return synthetic_beats(2272, T=90, n_clusters=4, n_outputs=WARP_LEADS,
                           noise=0.05, seed=0)


def _time_batch_warp(torch, model, y):
    """Seconds of one batched warp of every beat of lead 0 against beat
    0 (B = N, train_iter_batch Adam steps), median of three, on the
    model's device, with the model's prior and noise bounds."""
    Yd = torch.as_tensor(y[:, :, 0] / model._y_scale, dtype=torch.float64,
                         device=model.device)
    prior = model._warp_prior()
    n = float(model.cfg.warp.bound_noise_warp[0])
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model._warp_fn_batch(model._xb_dev, Yd, Yd[0], prior, 1.0, 1.0, n)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[1]


def phase_warp(torch, np):
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.utils.eval import classification_error
    y, z = _warp_beats()
    model = _warp_model(HDPGPC, y, SLICE_EST_LIMIT, "float32", "cuda")
    secs, launches = _counted(lambda: _sweep(
        torch, np, model, y, "chip_smoke_warp.log", with_warp=True,
        it_limit=WARP_SWEEPS))
    sweeps = len(model.train_elbo)
    err, tot = classification_error(model, z)
    wc = dict(model.warp_counts)
    t_warp = _time_batch_warp(torch, model, y)
    _say("warp", f"{y.shape[0]} beats x {y.shape[2]} leads, sweeps {sweeps}, "
         f"M {model.M}, {secs:.2f} s total, {secs / max(sweeps, 1):.3f} "
         f"s/sweep, error {err}/{tot}, f32_fragile {model.f32_fragile}, "
         f"batched warps {wc['batch']}, warp-cache hits "
         f"{wc['batch_hits']}, one batched warp (B={y.shape[0]}, "
         f"{model.cfg.warp.train_iter_batch} steps) {t_warp:.3f} s, "
         f"launches {launches}, refit memo hits/misses {model._memo_stats}")
    if not (sweeps and all(math.isfinite(e) for e in model.train_elbo)):
        raise AssertionError("non-finite or missing ELBO")
    if wc["batch"] <= 0:
        raise AssertionError("the sweep ran no warp")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


def phase_warp_parity(torch, np):
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    y = _warp_beats()[0][:WARP_PARITY_BEATS]
    runs, card = {}, None
    for dev in ("cuda", "cpu"):
        m = _warp_model(HDPGPC, y, 300, "float64", dev)
        secs, lc = _counted(lambda: _sweep(
            torch, np, m, y, f"chip_smoke_warp_parity_{dev}.log",
            with_warp=True, it_limit=WARP_PARITY_SWEEPS))
        runs[dev] = m
        card = lc if dev == "cuda" else card
        _say("warp_parity", f"{dev}: sweeps {len(m.train_elbo)}, M {m.M}, "
             f"{secs:.2f} s, batched warps {m.warp_counts['batch']}, "
             f"launches {lc}")
    same, rel = _same_sweeps(np, runs["cuda"], runs["cpu"])
    _say("warp_parity", f"identical partitions {same}, M {runs['cuda'].M} "
         f"vs {runs['cpu'].M}, max ELBO rel diff {rel:.3e}")
    if not (same and rel <= 1e-8):
        raise AssertionError("card and CPU warped sweeps disagree")
    return card


def phase_online_warp(torch, np):
    from hdpgpc_torch.data.loader import synthetic_growth_stream
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    y, _z = synthetic_growth_stream(**ONLINE_WARP)
    x = np.arange(y.shape[1], dtype=np.float64)
    from hdpgpc_torch.ops.spd_solve import spd_solve
    runs, card = {}, None
    for dev in ("cuda", "cpu"):
        m = _growth_model(HDPGPC, y, "float64", dev)
        part = {}

        def stream(m=m, part=part):
            for i in range(ONLINE_WARP_FREE):
                m.include_sample_fast(x, y[i], with_warp=False)
            part["births"] = m.M - 1
            part["b0"] = spd_solve.launches
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(ONLINE_WARP_FREE,
                           ONLINE_WARP_FREE + ONLINE_WARP_BEATS):
                m.include_sample_fast(x, y[i], with_warp=True)
            if dev == "cuda":
                torch.cuda.synchronize()
            part["secs"] = time.perf_counter() - t0
            part["b"] = spd_solve.launches - part["b0"]
        _, lc = _counted(lambda: _quiet(
            stream, f"chip_smoke_online_warp_{dev}.log"))
        runs[dev] = m
        card = lc if dev == "cuda" else card
        n, secs = ONLINE_WARP_BEATS, part["secs"]
        _say("online_warp", f"{dev}: {ONLINE_WARP_FREE} beats without the "
             f"warp ({part['births']} births), then {n} warped beats in "
             f"{secs:.2f} s, {secs / n:.4f} s/beat, M {m.M}, "
             f"{m.warp_counts['online'] / n:.3f} warps a beat "
             f"({m.cfg.warp.train_iter_online} steps each), "
             f"{part['b'] / n:.3f} kernel B a warped beat; launches in the "
             f"whole stream {lc}")
    a, b = runs["cuda"], runs["cpu"]
    same = (a.M == b.M and len(a.resp_assigned) == len(b.resp_assigned)
            and all(np.array_equal(p, q) for p, q in
                    zip(a.resp_assigned, b.resp_assigned)))
    _say("online_warp", f"identical decisions {same}, M {a.M} vs {b.M}")
    if not same:
        raise AssertionError("card and CPU warped streams disagree")
    if a.M < 2:
        raise AssertionError("no birth inside the streamed beats")
    if min(card.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {card}")
    return card


def phase_ml_em(torch, np):
    from hdpgpc_torch.data.loader import synthetic_beats
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    y, _z = synthetic_beats(2272, T=90, n_clusters=4, noise=0.05, seed=0)
    y = y[:ML_EM_BEATS]
    runs, card = {}, None
    for dev in ("cuda", "cpu"):
        m = _model(HDPGPC, y, 300, "float64", dev, bayesian_params=False)
        secs, lc = _counted(lambda: _sweep(torch, np, m, y,
                                           f"chip_smoke_ml_em_{dev}.log"))
        runs[dev] = m
        card = lc if dev == "cuda" else card
        sweeps = len(m.train_elbo)
        _say("ml_em", f"{dev}: sweeps {sweeps}, M {m.M}, {secs:.2f} s, "
             f"{secs / max(sweeps, 1):.3f} s/sweep, launches {lc}")
    same, rel = _same_sweeps(np, runs["cuda"], runs["cpu"])
    _say("ml_em", f"identical partitions {same}, M {runs['cuda'].M} vs "
         f"{runs['cpu'].M}, max ELBO rel diff {rel:.3e}")
    if not same:
        raise AssertionError("card and CPU ML-EM sweeps disagree")
    if card["spd_solve"] <= 0:
        raise AssertionError(f"kernel B was not launched: {card}")
    return card


def _timed(torch, fn, sync=True):
    """fn's result and its seconds (synchronised on the card)."""
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _reload_model(np, HDPGPC, y, z, dtype, device, n_train):
    """A model of the slice's configuration reloaded from the labels of
    the first ``n_train`` beats (priors from those beats)."""
    x = np.tile(np.arange(y.shape[1], dtype=np.float64), (n_train, 1))
    m = _model(HDPGPC, y[:n_train], SLICE_EST_LIMIT, dtype, device)
    return m, lambda: m.reload_model_from_labels(
        x, y[:n_train], z[:n_train], M=int(z.max()) + 1)


def _new_x(np, y):
    return np.tile(np.arange(y.shape[1], dtype=np.float64), (y.shape[0], 1))


def phase_reload(torch, np):
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    y, z = _warp_beats()
    n = RELOAD_TRAIN
    y_new, z_new = y[n:], z[n:]
    model, reload = _reload_model(np, HDPGPC, y, z, "float32", "cuda", n)
    launches = {}
    (_, secs), launches["reload"] = _counted(lambda: _timed(
        torch, lambda: _quiet(reload, "chip_smoke_reload.log")))
    (lab, secs_new), launches["classify"] = _counted(lambda: _timed(
        torch, lambda: _quiet(lambda: model.cluster_new_batch(
            _new_x(np, y_new), y_new), "chip_smoke_reload_classify.log")))
    acc_new = float(np.mean(lab == z_new))
    _say("reload", f"{n} beats x {y.shape[2]} leads reloaded from labels "
         f"in {secs:.2f} s, M {model.M}, ELBO {model.train_elbo[-1]:.6f}, "
         f"launches {launches['reload']}; cluster_new_batch on "
         f"{y_new.shape[0]} beats in {secs_new:.3f} s, accuracy "
         f"{acc_new:.4f}, launches {launches['classify']}")
    (lab_l, secs_l), launches["learn"] = _counted(lambda: _timed(
        torch, lambda: _quiet(lambda: model.cluster_new_batch(
            _new_x(np, y_new), y_new, learning=True,
            it_limit=RELOAD_LEARN_SWEEPS), "chip_smoke_reload_learn.log")))
    # learning reorders the clusters by size: count the beats off their
    # cluster's majority label
    err_l = _majority_error(np, lab_l, z)
    _say("reload", f"cluster_new_batch(learning=True, it_limit="
         f"{RELOAD_LEARN_SWEEPS}) on {y_new.shape[0]} new beats: "
         f"{secs_l:.2f} s, {len(model.train_elbo) - 1} sweeps, M {model.M}, "
         f"majority-label error over all {lab_l.shape[0]} beats {err_l}, "
         f"launches {launches['learn']}")
    if not all(math.isfinite(e) for e in model.train_elbo):
        raise AssertionError("non-finite ELBO")
    if acc_new < 0.95:
        raise AssertionError(f"new-beat accuracy {acc_new} < 0.95")
    for k, lc in launches.items():
        if lc["spd_solve"] <= 0:
            raise AssertionError(f"kernel B not launched in {k}: {lc}")
    if launches["reload"]["rbf_gram"] <= 0:
        raise AssertionError("kernel A not launched in the reload")
    snapshot = _save(model)
    _reload_parity(torch, np, y, z)
    total = {k: sum(lc[k] for lc in launches.values())
             for k in ("spd_solve", "rbf_gram")}
    return total, snapshot


def _save(model):
    """(the checkpoint path, the seconds save_swgp took, the model): the
    model saved as a format-2 checkpoint under chiprun_out/."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "chip_smoke_reload.npz")
    t0 = time.perf_counter()
    model.save_swgp(path)
    return path, time.perf_counter() - t0, model


def _reload_parity(torch, np, y, z):
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    n, k = RELOAD_PARITY_TRAIN, RELOAD_PARITY_NEW
    y, z = y[:n + k], z[:n + k]
    out = {}
    for dev in ("cuda", "cpu"):
        m, reload = _reload_model(np, HDPGPC, y, z, "float64", dev, n)
        t0 = time.perf_counter()

        def run(m=m, reload=reload):
            reload()
            a = m.resp_assigned[-1].copy()
            b = m.cluster_new_batch(_new_x(np, y[n:]), y[n:])
            c = m.cluster_new_batch(_new_x(np, y[n:]), y[n:], learning=True,
                                    it_limit=RELOAD_LEARN_SWEEPS)
            return a, b, c
        labs = _quiet(run, f"chip_smoke_reload_parity_{dev}.log")
        out[dev] = (m, labs)
        _say("reload", f"parity {dev}: {n} + {k} beats float64 in "
             f"{time.perf_counter() - t0:.2f} s, M {m.M}")
    (a, la), (b, lb) = out["cuda"], out["cpu"]
    same = all(np.array_equal(u, v) for u, v in zip(la, lb))
    same_sweeps, rel = _same_sweeps(np, a, b)
    _say("reload", f"parity: identical labels {same and same_sweeps}, M "
         f"{a.M} vs {b.M}, max ELBO rel diff {rel:.3e}")
    if not (same and same_sweeps and rel <= 1e-9):
        raise AssertionError("card and CPU supervised paths disagree")


def phase_checkpoint(torch, np, snapshot):
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    path, secs_save, model = snapshot
    y, _z = _warp_beats()
    y_new = y[RELOAD_TRAIN:]
    loaded = {}
    for dev in ("cuda", "cpu"):
        loaded[dev], secs = _timed(torch, lambda: HDPGPC.load_swgp(
            path, device=dev))
        _say("checkpoint", f"load_swgp on {dev}: {secs:.3f} s")
    labels, lc = _counted(lambda: [_quiet(
        lambda m=m: m.cluster_new_batch(_new_x(np, y_new), y_new),
        "chip_smoke_checkpoint.log")
        for m in (model, loaded["cuda"], loaded["cpu"])])
    same = all(np.array_equal(labels[0], x) for x in labels[1:])
    _say("checkpoint", f"{os.path.getsize(path)} bytes, save_swgp "
         f"{secs_save:.3f} s; identical cluster_new_batch labels "
         f"(card model, loaded on the card, loaded on the CPU) {same}; "
         f"launches {lc}")
    if not same:
        raise AssertionError("a loaded checkpoint labels otherwise")
    if lc["spd_solve"] <= 0:
        raise AssertionError(f"kernel B not launched: {lc}")
    return lc


def _stream_beats(np, K, T, n):
    """Templates as examples/run_stress_stream.py:180-185 builds them,
    the class means of a 50 K-beat warm-up, and ``n`` beats to stream
    (y (n, T), z). Warm-up and stream come from ONE seeded call:
    synthetic_beats draws the morphologies from its seed, and the
    example's templates (seed 0) and blocks (seed 1 + done) would hold
    other morphologies; tests/test_parallel.py:95-109 does the same."""
    from hdpgpc_torch.data.loader import synthetic_beats
    W = 50 * K
    y, z = synthetic_beats(W + n, T=T, n_clusters=K, noise=0.05, seed=0)
    tmpl = np.stack([y[:W][z[:W] == k][:, :, 0].mean(0) for k in range(K)])
    return tmpl, y[W:, :, 0], z[W:]


def _idle_share(torch, fn, table=None):
    """1 - (device time of the kernels) / (wall time) over one call of
    fn under torch.profiler; None where the profiler shows no device
    time. ``table``: a file under chiprun_out/ for the profiler's table
    of device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in ka if e.device_type == DeviceType.CUDA)
    if table:
        os.makedirs(OUT_DIR, exist_ok=True)
        key = "self_device_time_total" if hasattr(
            ka[0], "self_device_time_total") else "self_cuda_time_total"
        with open(os.path.join(OUT_DIR, table), "w") as f:
            f.write(ka.table(sort_by=key, row_limit=30))
    if dev_us <= 0:
        return None, wall
    return 1.0 - dev_us * 1e-6 / wall, wall


def phase_stream(torch, np):
    from hdpgpc_torch.models import streaming
    from hdpgpc_torch.ops.spd_solve import spd_solve, spd_solve_plain
    from hdpgpc_torch.utils.kernel_timing import spd_solve_bound
    K, T, dev = STREAM_K, STREAM_T, torch.device("cuda")
    chunk = streaming.stream_chunk(K, T, torch.float32,
                                   streaming.free_memory(dev))
    tmpl, y, z = _stream_beats(np, K, T, chunk + STREAM_TIMED)
    st = streaming.init_stream_state(
        torch.as_tensor(tmpl, dtype=torch.float32, device=dev),
        **STREAM_PRIORS)
    Y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    (st, lab0), secs0 = _timed(torch, lambda: streaming.stream_classify(
        st, Y[:chunk], chunk=chunk))
    n_chunks = -(-STREAM_TIMED // chunk)
    torch.cuda.reset_peak_memory_stats(dev)
    ((st, lab), secs), lc = _counted(lambda: _timed(
        torch, lambda: streaming.stream_classify(st, Y[chunk:],
                                                 chunk=chunk)))
    peak = torch.cuda.max_memory_allocated(dev)
    labels = np.concatenate([lab0, lab])
    acc = float(np.mean(labels == z))
    counted = float(st.counts.sum())
    finite = all(bool(torch.isfinite(v).all()) for v in st)
    idle, wall = _idle_share(torch, lambda: streaming.stream_classify(
        st, Y[chunk:2 * chunk], chunk=chunk), table="profile_stream.txt")
    idle_s = "not measured" if idle is None else f"{idle:.3f}"
    _say("stream", f"K {K}, T {T}, float32, chunk {chunk} (from "
         f"{streaming.free_memory(dev) / 2**30:.1f} GiB free now; "
         f"{streaming.LIVE_TT_PER_BEAT} (T, T) a cluster and beat in "
         f"{streaming.CHUNK_MEMORY_FRACTION} of it); first chunk "
         f"{secs0:.3f} s untimed; {STREAM_TIMED} beats in {secs:.3f} s: "
         f"{STREAM_TIMED / secs:.1f} beats/s, {1e3 * secs / n_chunks:.2f} "
         f"ms a chunk ({n_chunks} chunks), kernel B {lc['spd_solve']} "
         f"launches ({lc['spd_solve'] / n_chunks:.2f} a chunk), peak "
         f"memory {peak / 2**30:.3f} GiB ({peak / (chunk * K * T * T * 4):.2f}"
         f" (T, T) a cluster and beat), accuracy {acc:.4f}, counts "
         f"{counted:.0f} of {labels.shape[0]}, finite {finite}; one "
         f"profiled chunk {wall:.3f} s, idle share {idle_s}")
    if acc < STREAM_MIN_ACC:
        raise AssertionError(f"stream accuracy {acc} < {STREAM_MIN_ACC}")
    if counted != labels.shape[0] or not finite:
        raise AssertionError("stream counts or states wrong")
    if lc["spd_solve"] <= 0:
        raise AssertionError(f"kernel B not launched: {lc}")
    # kernel B at the classifier's two shapes: the scores (K systems
    # against the chunk's beats) and the filter elements' shared solve
    # (against [(Q H')', H, the beats])
    rec = {}
    for R in (chunk, 2 * T + chunk):
        spd_h, _ = _spd_inputs(np, K, T, R, 5.0)
        rhs_h = np.random.default_rng(R).standard_normal((K, T, R)) * 12.0
        spd = torch.as_tensor(spd_h, dtype=torch.float32, device=dev)
        rhs = torch.as_tensor(rhs_h, dtype=torch.float32, device=dev)
        X = spd_solve(spd, rhs)
        Xp = spd_solve_plain(spd, rhs)
        X64 = spd_solve_plain(spd.double(), rhs.double())
        torch.cuda.synchronize()
        err = float(((X.double() - X64).abs() / (X64.abs() + 1e-3)).max())
        dkp = float((X - Xp).abs().max())
        t = _timings(lambda: spd_solve(spd, rhs),
                     lambda: spd_solve_plain(spd, rhs),
                     lambda: torch.linalg.solve(spd, rhs),
                     spd_solve_bound(K, T, R, torch.float32))
        _say("stream", f"spd_solve ({K},{T},{T}) x R {R} float32: kernel "
             f"err {err:.3e} (bar {SOLVE_BAR['float32']:.0e}), max|kernel-"
             f"plain| {dkp:.3e}; " + _fmt_times(t))
        if not err < SOLVE_BAR["float32"]:
            raise AssertionError(f"spd_solve R={R} err {err}")
        rec[f"{K}x{T}x{T}xR{R}"] = {"float32": dict(max_abs_err=dkp, **t)}
    _stream_parity(torch, np)
    return lc, rec


def _stream_parity(torch, np):
    from hdpgpc_torch.models import streaming
    K, T = STREAM_PARITY_K, STREAM_T
    tmpl, y, _z = _stream_beats(np, K, T, STREAM_PARITY_BEATS)
    out = {}
    for dev in ("cuda", "cpu"):
        st = streaming.init_stream_state(
            torch.as_tensor(tmpl, dtype=torch.float64, device=dev),
            **STREAM_PRIORS)
        (st, lab), secs = _timed(torch, lambda: streaming.stream_classify(
            st, y, chunk=STREAM_PARITY_CHUNK), sync=dev == "cuda")
        out[dev] = (st, lab)
        _say("stream", f"parity {dev}: {STREAM_PARITY_BEATS} beats, K {K}, "
             f"float64, chunk {STREAM_PARITY_CHUNK}: {secs:.2f} s")
    (a, la), (b, lb) = out["cuda"], out["cpu"]
    rel = {f: float((getattr(a, f).cpu() - getattr(b, f)).abs().max()
                    / getattr(b, f).abs().max()) for f in ("f", "P", "fmsg")}
    same = np.array_equal(la, lb)
    counts = bool(torch.equal(a.counts.cpu(), b.counts))
    _say("stream", f"parity: identical labels {same}, counts equal "
         f"{counts}, rel diff " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in rel.items()))
    if not (same and counts and rel["f"] <= 1e-9 and rel["P"] <= 1e-9):
        raise AssertionError("card and CPU classifiers disagree")


def phase_inducing(torch, np):
    import dataclasses
    from hdpgpc_torch.data.loader import synthetic_beats
    from hdpgpc_torch.models import kernel_fit
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    y, _z = synthetic_beats(2272, T=90, n_clusters=4, noise=0.05, seed=0)
    x = np.arange(90, dtype=np.float64)
    yb = y[0, :, 0]
    bs = (0.01 * float(np.std(yb)) ** 2, float(np.std(yb)) ** 2)
    for name, iters in INDUCING_FIT_ITERS.items():
        fit = getattr(kernel_fit, f"fit_kernel_{name}")
        res = {}
        for dev in ("cuda", "cpu"):
            res[dev], secs = _timed(torch, lambda: fit(
                x, yb, bs, max_iters=iters, device=dev), sync=dev == "cuda")
            _say("inducing", f"fit_kernel_{name} {iters} iterations on "
                 f"{dev}: {secs:.3f} s")
        (ta, Za), (tb, Zb) = res["cuda"], res["cpu"]
        rel = max(abs(float(u) - float(v)) / abs(float(v))
                  for u, v in zip(ta, tb))
        dz = float((Za.cpu() - Zb).abs().max())
        _say("inducing", f"fit_kernel_{name}: theta rel diff {rel:.3e}, "
             f"max |dZ| {dz:.3e} (bars 1e-6, 1e-5)")
        if not (rel <= 1e-6 and dz <= 1e-5):
            raise AssertionError(f"card and CPU {name} fits disagree")
    (th, _Z), secs = _timed(torch, lambda: kernel_fit.fit_kernel_sgpr(
        x, yb, bs, device="cuda"))
    _say("inducing", f"fit_kernel_sgpr to its plateau stop (at most 5000 "
         f"iterations) on the card: {secs:.2f} s, theta "
         f"{[round(float(v), 6) for v in th]}")
    yp = y[:INDUCING_BEATS]
    runs, card = {}, None
    for dev in ("cuda", "cpu"):
        m = _model(HDPGPC, yp, 300, "float64", dev, inducing_points=True)
        m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
            m.cfg.gp, kernel_fit_iters_inducing=INDUCING_SWEEP_ITERS))
        secs, lc = _counted(lambda: _sweep(
            torch, np, m, yp, f"chip_smoke_inducing_{dev}.log",
            it_limit=INDUCING_SWEEPS))
        runs[dev] = m
        card = lc if dev == "cuda" else card
        _say("inducing", f"include_batch(inducing_points=True) {dev}: "
             f"sweeps {len(m.train_elbo)}, M {m.M}, {secs:.2f} s, launches "
             f"{lc}")
    same, rel = _same_sweeps(np, runs["cuda"], runs["cpu"])
    _say("inducing", f"identical partitions {same}, M {runs['cuda'].M} vs "
         f"{runs['cpu'].M}, max ELBO rel diff {rel:.3e}")
    if not same:
        raise AssertionError("card and CPU inducing sweeps disagree")
    if min(card.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {card}")
    return card


def _record_inputs(np, R, N, K, T=90):
    """R synthetic records (record r from seed r, lead 0) with hard
    responsibilities and transition pairs from the generating labels,
    and the initial sticks (numpy)."""
    from hdpgpc_torch.data.loader import synthetic_beats
    from hdpgpc_torch.ops import stick_breaking as sb
    Y = np.empty((R, N, T))
    z = np.empty((R, N), np.int64)
    for r in range(R):
        y, z[r] = synthetic_beats(N, T=T, n_clusters=K, noise=0.05, seed=r)
        Y[r] = y[:, :, 0]
    respPair = np.zeros((R, N, K, K))
    respPair[:, np.arange(1, N)[None, :], z[:, :-1], z[:, 1:]] = 1.0
    return dict(Y=Y, resp=np.eye(K)[z], respPair=respPair,
                rho=np.tile(sb.create_init_rho(K), (R, 1)),
                start_log_pi=np.log(np.ones((R, K)) / K),
                trans_log_pi=np.log(np.ones((R, K, K)) / K))


def _record_elbos(torch, out):
    """The per-record ELBOs of a step's outputs, in float64 on the host."""
    from hdpgpc_torch.ops import hmm
    q, q_lat, resp, respPair = (x.double().cpu() for x in out[:4])
    return (torch.sum(q * resp, dim=(1, 2))
            + torch.sum(q_lat * resp, dim=(1, 2))
            + hmm.entropy_terms(resp, respPair))


def phase_records(torch, np):
    from hdpgpc_torch.models import streaming
    from hdpgpc_torch.ops.kernels import fused_rbf_gram
    from hdpgpc_torch.ops.spd_solve import spd_solve
    from hdpgpc_torch.parallel import records
    R, N, K, T = RECORDS_R, RECORDS_N, RECORDS_K, 90
    dev, dt = torch.device("cuda"), torch.float32
    t0 = time.perf_counter()
    d = _record_inputs(np, R, N, K)
    Y, resp, rho, rp = (torch.as_tensor(d[k], dtype=dt, device=dev)
                        for k in ("Y", "resp", "rho", "respPair"))
    secs_data = time.perf_counter() - t0
    free = streaming.free_memory(dev)
    spd_solve.launches = 0
    fused_rbf_gram.launches = 0
    states = records.init_record_states(R, K, T, device=dev, dtype=dt)
    gram_launches = fused_rbf_gram.launches
    step = records.build_sharded_vi_step(T, K, est_limit=SLICE_EST_LIMIT,
                                         hdp_update=True, device=dev,
                                         **RECORDS_HDP)
    out, secs0 = _timed(torch, lambda: step(Y, resp, states, rho, rp))
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    secs = []
    for _ in range(RECORDS_TIMED):
        out, s_ = _timed(torch, lambda: step(Y, resp, states, rho, rp))
        secs.append(s_)
    peak = torch.cuda.max_memory_allocated(dev) - before
    G, groups = step.last_group_size, step.last_groups
    launches = {"spd_solve": spd_solve.launches,
                "rbf_gram": fused_rbf_gram.launches}
    per_step = launches["spd_solve"] / (RECORDS_TIMED + 1)
    elbo = float(out[4])
    per_rec = _record_elbos(torch, out)
    rel = abs(float(per_rec.sum()) - elbo) / abs(elbo)
    q_ok = bool(torch.isfinite(out[0]).all()) and out[0].shape == (R, N, K)
    # the idle share of a one-group step over the records' first
    # RECORDS_PROFILED beats: every sequential slot runs the same launch
    # chain, and a whole step's trace (~10^6 events) takes minutes to
    # parse
    W = RECORDS_PROFILED
    idle, wall = _idle_share(torch, lambda: step(
        Y[:G, :W], resp[:G, :W], _records_head(states, G), rho[:G],
        rp[:G, :W]), table="profile_records.txt")
    idle_s = "not measured" if idle is None else f"{idle:.3f}"
    s_step = sum(secs) / len(secs)
    tt = peak / (min(G, R) * K * N * T * T * 4)
    tt_none = _records_tt_no_limit(torch, Y, resp, states, rho, rp, G, K, T)
    _say("records", f"R {R} records x N {N} beats x K {K}, T {T}, float32, "
         f"est_limit {SLICE_EST_LIMIT}, hdp_update: data {secs_data:.2f} s; "
         f"first step {secs0:.2f} s "
         f"untimed; {RECORDS_TIMED} steps {[round(x, 3) for x in secs]} s: "
         f"{s_step:.3f} s/step, {R * N / s_step:.1f} beats/s; group "
         f"{G} records ({groups} groups a step, from "
         f"{free / 2**30:.1f} GiB free, {records.REFIT_LIVE_TT} (T, T) a "
         f"cluster and slot in {records.GROUP_MEMORY_FRACTION} of it); "
         f"kernel B {per_step:.1f} launches a step (one a sequential "
         f"forward slot and group) at ({4 * min(G, R) * K}, {T}, {T}); "
         f"kernel A "
         f"{gram_launches} launch(es) in init_record_states; peak "
         f"{peak / 2**30:.3f} GiB above the inputs ({tt:.2f} (T, T) a "
         f"cluster and slot of a group; at est_limit None, one group over "
         f"the first {RECORDS_NO_LIMIT_BEATS} beats: {tt_none:.2f}); ELBO "
         f"{elbo:.6f}, sum of the "
         f"per-record ELBOs rel diff {rel:.3e}, q finite {q_ok}; a "
         f"one-group step over {W} beats profiled {wall:.3f} s, idle "
         f"share {idle_s}")
    if not (math.isfinite(elbo) and q_ok):
        raise AssertionError("non-finite ELBO or q")
    if rel > 1e-5:
        raise AssertionError(f"ELBO {elbo} != sum of records ({rel})")
    if launches["spd_solve"] <= 0 or gram_launches <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    # kernel B at the step's shapes: a group's (4 G K, 90, 90) and all
    # R records' (4 R K, 90, 90)
    rec = {f"{n}x{T}x{T}": {"float32": _time_solve(torch, np, "records", n,
                                                   T, dt)}
           for n in sorted({4 * min(G, R) * K, 4 * R * K})}
    return launches, rec


def _time_solve(torch, np, phase, n, T, dt):
    """Kernel B at (n, T, T) x R = T in ``dt`` against a float64 truth
    (SOLVE_BAR) and its plain version, timed: its record."""
    from hdpgpc_torch.ops.spd_solve import spd_solve, spd_solve_plain
    from hdpgpc_torch.utils.kernel_timing import spd_solve_bound
    dname = str(dt).replace("torch.", "")
    spd_h, rhs_h = _spd_inputs(np, n, T, n, 5.0)
    spd = torch.as_tensor(spd_h, dtype=dt, device="cuda")
    rhs = torch.as_tensor(rhs_h, dtype=dt, device="cuda")
    X = spd_solve(spd, rhs)
    Xp = spd_solve_plain(spd, rhs)
    X64 = spd_solve_plain(spd.double(), rhs.double())
    torch.cuda.synchronize()
    err = float(((X.double() - X64).abs() / (X64.abs() + 1e-3)).max())
    dkp = float((X - Xp).abs().max())
    t = _timings(lambda: spd_solve(spd, rhs),
                 lambda: spd_solve_plain(spd, rhs),
                 lambda: torch.linalg.solve(spd, rhs),
                 spd_solve_bound(n, T, T, dt))
    _say(phase, f"spd_solve ({n},{T},{T}) {dname}: kernel err {err:.3e} "
         f"(bar {SOLVE_BAR[dname]:.0e}), max|kernel-plain| {dkp:.3e}; "
         + _fmt_times(t))
    if not err < SOLVE_BAR[dname]:
        raise AssertionError(f"spd_solve ({n}, {T}) {dname} err {err}")
    return dict(max_abs_err=dkp, **t)


def _records_tt_no_limit(torch, Y, resp, states, rho, rp, G, K, T):
    """The peak (T, T) count a cluster and slot of a one-group step at
    est_limit None (every slot its own factors) over the first
    RECORDS_NO_LIMIT_BEATS beats."""
    from hdpgpc_torch.parallel import records
    dev, W = Y.device, RECORDS_NO_LIMIT_BEATS
    step = records.build_sharded_vi_step(T, K, hdp_update=True, device=dev,
                                         records_per_group=G, **RECORDS_HDP)
    args = (Y[:G, :W], resp[:G, :W], _records_head(states, G), rho[:G],
            rp[:G, :W])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    return peak / (G * K * W * T * T * Y.element_size())


def _records_head(states, G):
    """The first G records of (R, K)-batched states."""
    from hdpgpc_torch.models import gplds
    return gplds.tree_map(lambda x: x[:G], states)


def _records_rel(torch, a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def phase_records_parity(torch, np):
    import torch.distributed as dist
    from hdpgpc_torch import convert
    from hdpgpc_torch.entry import _free_port, entry
    from hdpgpc_torch.parallel import records
    R, N, K = (RECORDS_PARITY[k] for k in ("R", "N", "K"))
    T = 90
    d = _record_inputs(np, R, N, K)
    lc_all = {"spd_solve": 0, "rbf_gram": 0}
    for hdp in (False, True):
        a4, a5 = ("rho", "respPair") if hdp else ("start_log_pi",
                                                  "trans_log_pi")
        outs = {}
        for dev in ("cuda", "cpu"):
            step = records.build_sharded_vi_step(
                T, K, hdp_update=hdp, device=dev, **RECORDS_HDP)
            (out, secs), lc = _counted(lambda: _timed(torch, lambda: step(
                d["Y"], d["resp"], records.init_record_states(
                    R, K, T, device=dev), d[a4], d[a5]),
                sync=dev == "cuda"))
            outs[dev] = out
            if dev == "cuda":
                lc_all = {k: lc_all[k] + v for k, v in lc.items()}
            _say("records_parity", f"hdp_update {hdp} on {dev}: R {R}, N "
                 f"{N}, K {K}, float64: {secs:.2f} s, launches {lc}")
        a, b = outs["cuda"], outs["cpu"]
        same = all(torch.equal(a[i].cpu(), b[i]) for i in (2, 3))
        rel = max(_records_rel(torch, a[i], b[i]) for i in (0, 1, 4))
        rel_st = max(_records_rel(torch, x, y) for x, y in zip(
            convert.tree_leaves(a[5]), convert.tree_leaves(b[5]))
            if x.is_floating_point())
        _say("records_parity", f"hdp_update {hdp}: identical resp and "
             f"respPair {same}; q, q_lat, ELBO max rel diff {rel:.3e}; "
             f"states {rel_st:.3e}")
        if not (same and rel <= 1e-9 and rel_st <= 1e-9):
            raise AssertionError(f"card and CPU steps disagree (hdp {hdp})")
    # the same step through a one-rank NCCL group
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        outs = []
        for group in (dist.group.WORLD, None):
            step = records.build_sharded_vi_step(
                T, K, hdp_update=True, device="cuda", group=group,
                **RECORDS_HDP)
            outs.append(step(d["Y"], d["resp"], records.init_record_states(
                R, K, T, device="cuda"), d["rho"], d["respPair"]))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(x, y) for x, y in zip(outs[0][:5], outs[1][:5]))
    _say("records_parity", f"one-rank NCCL group: identical to the step "
         f"without a group {same} (ELBO {float(outs[0][4]):.6f})")
    if not same:
        raise AssertionError("the NCCL group changed the step")
    fn, args = entry()
    (q, q_lat, f_last), secs = _timed(torch, lambda: fn(*args))
    ok = (bool(torch.isfinite(q).all() and torch.isfinite(q_lat).all()
               and torch.isfinite(f_last).all())
          and q.shape == (64,) and f_last.shape == (90, 1))
    _say("records_parity", f"entry() on the card: one refit at T 90, N 64 "
         f"in {secs:.3f} s, finite outputs of the expected shapes {ok}")
    if not ok:
        raise AssertionError("entry() gave wrong outputs")
    # kernel B at the parity step's (4 R K, 90, 90) in float64
    n = 4 * R * K
    return lc_all, {f"{n}x{T}x{T}": {"float64": _time_solve(
        torch, np, "records_parity", n, T, torch.float64)}}


TIMING_BEATS = 300
TIMING_KEYS = {"refit_batch", "refit_one", "seed_score", "fb", "kernel_fit",
               "q_elbo", "hdp_update", "warp"}


def phase_timing(torch, np):
    from hdpgpc_torch.data.loader import synthetic_beats
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    y, _z = synthetic_beats(2272, T=90, n_clusters=4, noise=0.05, seed=0)
    y = y[:TIMING_BEATS]
    runs = {}
    for timing in (False, True):
        if timing:
            os.environ["HDPGPC_TIMING"] = "1"
        try:
            m = _model(HDPGPC, y, SLICE_EST_LIMIT, "float32", "cuda")
        finally:
            os.environ.pop("HDPGPC_TIMING", None)
        secs, lc = _counted(lambda: _sweep(
            torch, np, m, y, f"chip_smoke_timing_{int(timing)}.log"))
        runs[timing] = (m, secs, lc)
        _say("timing", f"HDPGPC_TIMING={int(timing)}: sweeps "
             f"{len(m.train_elbo)}, M {m.M}, {secs:.3f} s, launches {lc}")
    (a, _sa, _la), (b, secs, lc) = runs[False], runs[True]
    same, rel = _same_sweeps(np, a, b)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        b.print_timings()
    for ln in buf.getvalue().splitlines():
        _say("timing", ln.strip())
    tracked = sum(b.timings.values())
    keys_ok = set(b.timings) <= TIMING_KEYS and not a.timings
    _say("timing", f"identical partitions {same} (ELBO rel diff "
         f"{rel:.3e}); keys {sorted(b.timings)} within the eight "
         f"{keys_ok}; tracked {tracked:.3f} s of the sweep's {secs:.3f} s")
    if not (same and keys_ok and b.timings and tracked <= secs):
        raise AssertionError("the timed sweep differs or its timings are "
                             "wrong")
    return lc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not os.path.isdir(os.path.join(ROOT, "hdpgpc_torch", "csrc")):
        print("chip_smoke.py: hdpgpc_torch/csrc not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import hdpgpc_torch  # noqa: F401  (sets the TF32 switches)
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    phase_device(torch)
    # launches stay null ("not measured") where their phase did not run
    rec = {}
    launches = {k: {p: None for p in ("offline", "online", "growth", "warp",
                                      "warp_parity", "online_warp", "ml_em",
                                      "reload", "checkpoint", "stream",
                                      "inducing", "records",
                                      "records_parity", "timing")}
                for k in ("spd_solve", "rbf_gram")}
    if "build" in phases or "kernels" in phases:
        phase_build()
    if "kernels" in phases:
        rec = phase_kernels(torch, np)
    if "slice" in phases:
        for k, v in phase_slice(torch, np).items():
            launches[k]["offline"] = v
    if "parity" in phases:
        phase_parity(torch, np)
    if "online" in phases:
        for k, v in phase_online(torch, np).items():
            launches[k]["online"] = v
    if "online_parity" in phases:
        phase_online_parity(torch, np)
    for name, fn in (("growth", phase_growth), ("warp", phase_warp), ("warp_parity", phase_warp_parity),
                     ("online_warp", phase_online_warp),
                     ("ml_em", phase_ml_em)):
        if name in phases:
            for k, v in fn(torch, np).items():
                launches[k][name] = v
    snapshot = None
    if "reload" in phases:
        lc, snapshot = phase_reload(torch, np)
        for k, v in lc.items():
            launches[k]["reload"] = v
    if "checkpoint" in phases:
        if snapshot is None:
            from hdpgpc_torch.models.hdpgpc import HDPGPC
            y, z = _warp_beats()
            model, reload = _reload_model(np, HDPGPC, y, z, "float32",
                                          "cuda", RELOAD_TRAIN)
            _quiet(reload, "chip_smoke_reload.log")
            snapshot = _save(model)
        for k, v in phase_checkpoint(torch, np, snapshot).items():
            launches[k]["checkpoint"] = v
    stream_shapes = {}
    if "stream" in phases:
        lc, stream_shapes = phase_stream(torch, np)
        for k, v in lc.items():
            launches[k]["stream"] = v
    if "inducing" in phases:
        for k, v in phase_inducing(torch, np).items():
            launches[k]["inducing"] = v
    if "records" in phases:
        lc, records_shapes = phase_records(torch, np)
        stream_shapes.update(records_shapes)
        for k, v in lc.items():
            launches[k]["records"] = v
    if "records_parity" in phases:
        lc, parity_shapes = phase_records_parity(torch, np)
        stream_shapes.update(parity_shapes)
        for k, v in lc.items():
            launches[k]["records_parity"] = v
    if "timing" in phases:
        for k, v in phase_timing(torch, np).items():
            launches[k]["timing"] = v
    src = {"spd_solve": ("hdpgpc_torch/csrc/spd_solve.cu",
                         "hdpgpc_tpu/ops/pallas/chol_solve.py:295"),
           "rbf_gram": ("hdpgpc_torch/csrc/rbf_gram.cu",
                        "hdpgpc_tpu/ops/pallas/gram.py:44")}
    # the timings and max_abs_err at the main path's dtype (float32) and
    # the offline refit's shape; the float64 numbers ride along under
    # "float64", kernel B's other timed shapes under "shapes"
    kernels = []
    for name in src:
        if f"{name}_float32" not in rec:
            continue
        entry = {"name": name, "route": "cuda", "source": src[name][0],
                 "replaces": src[name][1], "launches": launches[name],
                 **rec[f"{name}_float32"],
                 "float64": rec[f"{name}_float64"]}
        if name == "spd_solve":
            entry["shapes"] = {
                f"{n}x{T}x{T}": {d: rec[f"spd_solve_{n}x{T}x{T}_{d}"]
                                 for d in ("float32", "float64")}
                for (n, T) in SOLVE_TIMED if (n, T) != (16, 90)}
            # a shape timed in two phases keeps each phase's dtypes
            for key, by_dtype in stream_shapes.items():
                entry["shapes"][key] = {**by_dtype,
                                        **entry["shapes"].get(key, {})}
        else:
            entry["shapes"] = {
                f"{T}x{D}": {d: rec[f"rbf_gram_{T}x{D}_{d}"]
                             for d in ("float32", "float64")}
                for (T, D) in GRAM_ND_SHAPES if T == 90}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
