"""Where the time of hdpgpc_torch's offline sweep goes, on one CUDA card.

    python3 tools/torch_profile_sweep.py [--beats 2272] [--est 1000]
        [--dtype float32] [--warm 1] [--no-refit-profile] [--no-kernels]

1. kernels: kernel B (spd_solve) and kernel A (rbf_gram) against their
   plain versions at a few shapes, CUDA-event times over 200 launches;
2. phases: ``HDPGPC.include_batch`` on synthetic beats at record 100's
   shape in chip_smoke.py's slice configuration, once cold and ``--warm``
   times more (the kernel fits are memoised process-wide, so a later run
   skips them). Each phase method is timed with a CUDA sync on entry and
   exit, and a nested phase's time is taken out of its caller's, so the
   columns add up to at most the wall time;
3. refit: the last of the cold run's largest refit batches (4 jobs on
   the full slice), re-run alone
   (median of 3) and once under torch.profiler: device time, idle share
   (1 - kernel time / wall time), and the top host and device items.

Prints one line per result; the profiler tables go to
``chiprun_out/profile_refit.txt``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hdpgpc_torch  # noqa: E402,F401  (sets the TF32 switches)
from hdpgpc_torch.data.loader import (default_x_basis,  # noqa: E402
                                      synthetic_beats)
from hdpgpc_torch.data.priors import compute_estimators_lds  # noqa: E402
from hdpgpc_torch.models.hdpgpc import HDPGPC  # noqa: E402
from hdpgpc_torch.ops.kernels import fused_rbf_gram, rbf_gram  # noqa: E402
from hdpgpc_torch.ops.spd_solve import (spd_solve,  # noqa: E402
                                        spd_solve_plain)
from hdpgpc_torch.utils.eval import classification_error  # noqa: E402

OUT_DIR = os.path.join(ROOT, "chiprun_out")
PHASES = {"refit": ("_full_refit_batch_raw",),
          "kernel_fit": ("_prefetch_kernel_fits", "_maybe_kernel_fit"),
          "seed_score": ("_seed_score",),
          "fb": ("_fb_hard",),
          "elbo": ("compute_q_elbo",),
          "hdp_globals": ("_hdp_global_update",)}
SOLVE_SHAPES = ((16, 90, 90), (16, 90, 1), (1, 90, 90), (16, 32, 32),
                (16, 128, 128))


def _events_ms(fn, reps=200, warm=10):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bench_kernels(dev):
    rng = np.random.default_rng(0)
    for dt in (torch.float32, torch.float64):
        for (n, T, R) in SOLVE_SHAPES:
            M = rng.standard_normal((n, T, T))
            spd = torch.as_tensor((M @ M.transpose(0, 2, 1) + 5.0 * np.eye(T))
                                  * 37.0, dtype=dt, device=dev)
            rhs = torch.as_tensor(rng.standard_normal((n, T, R)) * 12.0,
                                  dtype=dt, device=dev)
            ms = _events_ms(lambda: spd_solve(spd, rhs))
            pms = _events_ms(lambda: spd_solve_plain(spd, rhs))
            print(f"[kernels] spd_solve ({n},{T},{R}) {dt}: kernel {ms:.4f} "
                  f"ms, plain {pms:.4f} ms", flush=True)
        x = torch.arange(90, dtype=dt, device=dev)
        c = torch.tensor(300.0, dtype=dt, device=dev)
        ls = torch.tensor(1.2, dtype=dt, device=dev)
        ms = _events_ms(lambda: fused_rbf_gram(x, x, c, ls))
        pms = _events_ms(lambda: rbf_gram(x, x, c, ls))
        print(f"[kernels] rbf_gram T=90 {dt}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms", flush=True)


class PhaseTimer:
    """Exclusive wall time per phase method, CUDA-synchronised."""

    def __init__(self):
        self.secs = {k: 0.0 for k in PHASES}
        self.calls = {k: 0 for k in PHASES}
        self._stack = []  # [phase, start, time of nested phases]
        # the last of the largest refit batches, with update_params
        self.last_batch = (None, [])

    def wrap(self, phase, fn):
        @functools.wraps(fn)
        def timed(model, *args, **kwargs):
            torch.cuda.synchronize()
            self._stack.append([phase, time.perf_counter(), 0.0])
            try:
                return fn(model, *args, **kwargs)
            finally:
                torch.cuda.synchronize()
                _, t0, inner = self._stack.pop()
                dt = time.perf_counter() - t0
                self.secs[phase] += dt - inner
                self.calls[phase] += 1
                if self._stack:
                    self._stack[-1][2] += dt
                if (fn.__name__ == "_full_refit_batch_raw"
                        and kwargs.get("update_params", True)
                        and len(args[0]) >= len(self.last_batch[1])):
                    self.last_batch = (model, list(args[0]))
        return timed

    def install(self):
        for phase, names in PHASES.items():
            for name in names:
                setattr(HDPGPC, name, self.wrap(phase, getattr(HDPGPC, name)))

    def reset(self):
        self.secs = {k: 0.0 for k in PHASES}
        self.calls = {k: 0 for k in PHASES}


def _model(y, est, dtype):
    std, std_dif, bs, bg = compute_estimators_lds(y)
    # chip_smoke.py's slice configuration (bench.py:58-68 with
    # reestimate_initial_params=False and its estimation limit)
    return HDPGPC(default_x_basis(y.shape[1]), n_outputs=y.shape[2],
                  ini_lengthscale=3.0, bound_lengthscale=(1.0, 20.0),
                  ini_gamma=std_dif, ini_sigma=std, ini_outputscale=300.0,
                  bound_sigma=bs, bound_gamma=bg, verbose=False,
                  hmm_switch=True, max_models=100, bayesian_params=True,
                  reestimate_initial_params=False, n_explore_steps=5,
                  free_deg_MNIV=5, estimation_limit=est,
                  compute_dtype=dtype, device="cuda")


def run_phases(args, timer):
    y, z = synthetic_beats(args.beats, T=90, n_clusters=4, noise=0.05,
                           seed=0)
    x = np.tile(np.arange(90, dtype=np.float64), (y.shape[0], 1))
    for run in range(1 + args.warm):
        timer.reset()
        m = _model(y, args.est, args.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            m.include_batch(x, y, with_warp=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sweeps = len(m.train_elbo)
        err, tot = classification_error(m, z)
        cols = ", ".join(f"{k} {timer.secs[k]:.2f} s x{timer.calls[k]}"
                         for k in PHASES)
        other = wall - sum(timer.secs.values())
        print(f"[phases] {'cold' if run == 0 else 'warm'}: wall {wall:.2f} "
              f"s, {sweeps} sweeps, {wall / max(sweeps, 1):.3f} s/sweep, M "
              f"{m.M}, error {err}/{tot}; {cols}, other {other:.2f} s",
              flush=True)
        if run == 0:
            batch = timer.last_batch
    return batch


def profile_refit(batch):
    model, jobs = batch
    raw = HDPGPC._full_refit_batch_raw.__wrapped__
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw(model, jobs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    n_members = [int(np.sum(rc > 0.99)) for (_cl, _ld, _Y, rc) in jobs]
    print(f"[refit] {len(jobs)} jobs, N {jobs[0][2].shape[0]}, members "
          f"{n_members}: "
          f"median {1e3 * statistics.median(walls):.1f} ms of 3 "
          f"({', '.join(f'{1e3 * w:.1f}' for w in walls)})", flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw(model, jobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()

    def dev_self(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # the kernels alone: an operator's row repeats its kernels' time
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_self(e) for e in kernels)
    launches = sum(e.count for e in avg if e.key == "cudaLaunchKernel")
    print(f"[refit] under torch.profiler: wall {1e3 * wall:.1f} ms, device "
          f"time {device_us / 1e3:.1f} ms, idle share "
          f"{1.0 - device_us / 1e6 / wall:.3f}, cudaLaunchKernel calls "
          f"{launches}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "profile_refit.txt")
    with open(path, "w") as f:
        f.write(avg.table(sort_by="self_cpu_time_total", row_limit=25))
        f.write("\n")
        key = ("self_device_time_total" if hasattr(avg[0],
               "self_device_time_total") else "self_cuda_time_total")
        f.write(avg.table(sort_by=key, row_limit=25))
    for e in sorted(kernels, key=dev_self, reverse=True)[:5]:
        print(f"[refit] device {dev_self(e) / 1e3:.1f} ms x{e.count}: "
              f"{e.key[:70]}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--beats", type=int, default=2272)
    ap.add_argument("--est", type=int, default=1000)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--warm", type=int, default=1)
    ap.add_argument("--no-refit-profile", action="store_true")
    ap.add_argument("--no-kernels", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_sweep.py needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not args.no_kernels:
        bench_kernels(torch.device("cuda"))
    timer = PhaseTimer()
    timer.install()
    batch = run_phases(args, timer)
    if not args.no_refit_profile:
        profile_refit(batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
