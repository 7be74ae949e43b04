"""Where the time of hdpgpc_torch's monotone warp goes, on one CUDA card.

    python3 tools/torch_profile_warp.py

The two warps the model runs (warp/monotone.py::build_batch_warp, float64,
T = 90, n_ctrl = 8, the template among the rows):

1. the batch warp of the offline sweep: B = 2272 beats, 50 Adam steps;
2. the online warp of one beat: B = 1, 250 Adam steps.

For each: seconds of one call (median of three, host clock around a
synchronised call) and ms per Adam step; then one call under
torch.profiler: cudaLaunchKernel calls per step, device time, idle share
(1 - kernel time / wall time). Prints one line per result; the profiler
tables go to ``chiprun_out/profile_warp.txt``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hdpgpc_torch  # noqa: E402,F401  (sets the TF32 switches)
from hdpgpc_torch.data.loader import synthetic_beats  # noqa: E402
from hdpgpc_torch.warp.monotone import (build_batch_warp,  # noqa: E402
                                        make_warp_prior)

OUT_DIR = os.path.join(ROOT, "chiprun_out")
T = 90


def _call(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profile(name, fn, steps, out):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    secs = sorted(_call(fn) for _ in range(3))[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _call(fn)
    avg = prof.key_averages()

    def dev_self(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    device_us = sum(dev_self(e) for e in avg
                    if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in avg if e.key == "cudaLaunchKernel")
    print(f"[warp] {name}: {secs:.4f} s a call, {1e3 * secs / steps:.3f} "
          f"ms a step; under torch.profiler {1e3 * wall:.1f} ms, "
          f"{launches / steps:.1f} cudaLaunchKernel a step ({launches} in "
          f"the call), device time {device_us / 1e3:.2f} ms, idle share "
          f"{1.0 - device_us / 1e6 / wall:.3f}", flush=True)
    out.write(f"==== {name}\n")
    out.write(avg.table(sort_by="self_cpu_time_total", row_limit=25))
    out.write("\n")


def main():
    if not torch.cuda.is_available():
        print("torch_profile_warp.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    y, _z = synthetic_beats(2272, T=T, n_clusters=4, noise=0.05, seed=0)
    dev = torch.device("cuda")
    x = torch.arange(T, dtype=torch.float64, device=dev)
    Y = torch.as_tensor(y[:, :, 0], dtype=torch.float64, device=dev)
    std = float(np.std(y))
    prior = make_warp_prior(x, std * 0.1, (std * 0.01, std * 0.02))
    n = std * 0.01
    batch = build_batch_warp(T, train_iter=50)
    online = build_batch_warp(T, train_iter=250)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_warp.txt"), "w") as out:
        _profile("batch warp (B=2272, 50 steps)",
                 lambda: batch(x, Y, Y[0], prior, 1.0, 1.0, n), 50, out)
        _profile("online warp (B=1, 250 steps)",
                 lambda: online(x, Y[5:6], Y[0], prior, 1.0, 1.0, n), 250,
                 out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
