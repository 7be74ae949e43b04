"""Where the time of hdpgpc_torch's online stream engine goes, on one
CUDA card.

    python3 tools/torch_profile_online.py [--beats 32] [--dtype float32]

chip_smoke.py's online configuration (the growth stream, K = 16 slots,
chunk 32, the growth stress priors):

1. warm-up: the first 96 beats, untimed (the first kernel fit);
2. steady: the next ``--beats`` beats (no birth there: the second
   morphology enters at beat 200), host clock around a synchronised
   run, HDP refresh included: ms per beat;
3. the next ``--beats`` beats under torch.profiler: device time, idle
   share (1 - kernel time / wall time), cudaLaunchKernel calls and
   host-to-device copies per beat, the top host and device items;
4. one first-member kernel fit alone (kernel_fit._adam_fit at T = 90 in
   the model dtype, as the engine runs it on a birth): seconds, and ms
   per Adam iteration from a 100-iteration run.

Prints one line per result; the profiler tables go to
``chiprun_out/profile_online.txt``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hdpgpc_torch  # noqa: E402,F401  (sets the TF32 switches)
from hdpgpc_torch.data.loader import (default_x_basis,  # noqa: E402
                                      synthetic_growth_stream)
from hdpgpc_torch.models.hdpgpc import HDPGPC  # noqa: E402
from hdpgpc_torch.models.kernel_fit import _adam_fit  # noqa: E402
from hdpgpc_torch.models.stream_online import (  # noqa: E402
    OnlineStreamEngine)

OUT_DIR = os.path.join(ROOT, "chiprun_out")
WARM = 96


def _model(y, dtype):
    w = y[:256]
    std = float(np.std(w))
    sd = float(np.std(np.diff(w, axis=0)))
    return HDPGPC(default_x_basis(y.shape[1]), n_outputs=1,
                  ini_lengthscale=3.0, bound_lengthscale=(1.0, 20.0),
                  ini_gamma=sd, ini_sigma=std, ini_outputscale=4.0,
                  bound_sigma=(std * 0.05, std * 0.2),
                  bound_gamma=(sd * 0.05, sd * 0.2), verbose=False,
                  hmm_switch=True, max_models=16, bayesian_params=True,
                  estimation_limit=50, free_deg_MNIV=5,
                  compute_dtype=dtype, device="cuda")


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--beats", type=int, default=32)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_online.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    y, _z = synthetic_growth_stream(800, 90, 4, seed=7, start_beat=0,
                                    interval=200)
    model = _model(y, args.dtype)
    eng = OnlineStreamEngine(model, K=16, chunk=32)
    B = args.beats
    warm = _timed(lambda: eng.run(y[:WARM]))
    print(f"[online] warm-up {WARM} beats (one kernel fit): {warm:.3f} s",
          flush=True)
    secs = _timed(lambda: eng.run(y[WARM:WARM + B]))
    print(f"[online] steady {B} beats: {secs:.3f} s, "
          f"{1e3 * secs / B:.2f} ms/beat", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _timed(lambda: eng.run(y[WARM + B:WARM + 2 * B]))
    avg = prof.key_averages()

    def dev_self(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_self(e) for e in kernels)
    count = {k: sum(e.count for e in avg if e.key == k)
             for k in ("cudaLaunchKernel", "cudaMemcpyAsync",
                       "cudaStreamSynchronize")}
    print(f"[online] under torch.profiler, {B} beats: wall "
          f"{1e3 * wall:.1f} ms ({1e3 * wall / B:.2f} ms/beat), device "
          f"time {device_us / 1e3:.1f} ms, idle share "
          f"{1.0 - device_us / 1e6 / wall:.3f}, per beat: "
          + ", ".join(f"{k} {v / B:.1f}" for k, v in count.items()),
          flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_online.txt"), "w") as f:
        f.write(avg.table(sort_by="self_cpu_time_total", row_limit=30))
        f.write("\n")
        key = ("self_device_time_total" if hasattr(avg[0],
               "self_device_time_total") else "self_cuda_time_total")
        f.write(avg.table(sort_by=key, row_limit=30))
    host = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host[:6]:
        print(f"[online] host {e.self_cpu_time_total / 1e3:.1f} ms "
              f"x{e.count}: {e.key[:60]}", flush=True)
    for e in sorted(kernels, key=dev_self, reverse=True)[:5]:
        print(f"[online] device {dev_self(e) / 1e3:.1f} ms x{e.count}: "
              f"{e.key[:70]}", flush=True)

    g = model.cfg.gp
    dt = model.dtype
    x = torch.as_tensor(model.x_basis, dtype=dt, device="cuda")
    Y1 = torch.as_tensor(y[WARM:WARM + 1] / model._y_scale, dtype=dt,
                         device="cuda")
    lo, hi = (torch.tensor(v, dtype=dt, device="cuda")
              for v in model._def_bound_sigma)
    fit = _timed(lambda: _adam_fit(x, Y1, lo, hi, g.kernel_fit_iters,
                                   g.kernel_fit_lr))
    it100 = _timed(lambda: _adam_fit(x, Y1, lo, hi, 100, g.kernel_fit_lr))
    print(f"[online] one kernel fit (max {g.kernel_fit_iters} iterations, "
          f"{args.dtype}): {fit:.3f} s; {1e3 * it100 / 100:.3f} ms per "
          "Adam iteration", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
