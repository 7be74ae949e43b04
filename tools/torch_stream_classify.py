"""The fixed-K stress run of the frozen-cluster classifier on one CUDA
card: BASELINE config 5 (docs/STRESS.md), the default branch of
examples/run_stress_stream.py, through hdpgpc_torch.

    python3 tools/torch_stream_classify.py [--beats 1000000] [--k 64]

K clusters of T = 90 in float32 with the example's priors
(ini_gamma=0.001, ini_sigma=0.05); templates are the class means of a
50 K-beat warm-up. Warm-up and stream come from ONE seeded
synthetic_beats call: synthetic_beats draws its morphologies from the
seed, so the example's templates (seed 0) and blocks (seed 1 + done)
hold other morphologies. The chunk is sized from the free device memory
(models/streaming.stream_chunk). The stream goes through
stream_classify in blocks of 65,536 beats (the example's generation
block); the first block is the warm-up of the timing. Prints the card's
name and power limit, a line per four blocks and the result, which also
goes to ``chiprun_out/torch_stream_classify.json``.
"""

from __future__ import annotations

import argparse
import json
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
from hdpgpc_torch.models import streaming  # noqa: E402
from hdpgpc_torch.ops.spd_solve import spd_solve  # noqa: E402

OUT_DIR = os.path.join(ROOT, "chiprun_out")
BLOCK = 65536


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--beats", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--t", type=int, default=90)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_stream_classify.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    K, T, dev = args.k, args.t, torch.device("cuda")
    W = 50 * K
    y, z = synthetic_beats(W + args.beats, T=T, n_clusters=K, noise=0.05,
                           seed=0)
    tmpl = np.stack([y[:W][z[:W] == k][:, :, 0].mean(0) for k in range(K)])
    Y = torch.as_tensor(y[W:, :, 0], dtype=torch.float32, device=dev)
    z = z[W:]
    del y
    st = streaming.init_stream_state(
        torch.as_tensor(tmpl, dtype=torch.float32, device=dev),
        ini_gamma=0.001, ini_sigma=0.05)
    chunk = streaming.stream_chunk(K, T, torch.float32,
                                   streaming.free_memory(dev))
    print(f"K {K}, T {T}, float32, {args.beats} beats, chunk {chunk}",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    correct, done, t0, t_warm = 0, 0, None, None
    launches0 = spd_solve.launches
    while done < args.beats:
        n = min(BLOCK, args.beats - done)
        st, lab = streaming.stream_classify(st, Y[done:done + n],
                                            chunk=chunk)
        correct += int(np.sum(lab == z[done:done + n]))
        done += n
        torch.cuda.synchronize()
        if t0 is None:
            t0, t_warm = time.perf_counter(), done
        elif (done // BLOCK) % 4 == 0:
            dt = time.perf_counter() - t0
            print(f"{done}/{args.beats} beats  {(done - t_warm) / dt:.1f} "
                  f"beats/s  acc={correct / done:.4f}", flush=True)
    dt = time.perf_counter() - t0
    timed = done - t_warm
    res = {"card": card, "K": K, "T": T, "dtype": "float32",
           "beats": done, "chunk": chunk,
           "beats_per_s": timed / dt if timed else None,
           "seconds_timed": dt, "beats_timed": timed,
           "accuracy": correct / done,
           "counts_sum": float(st.counts.sum()),
           "finite": all(bool(torch.isfinite(v).all()) for v in st),
           "kernel_b_launches": spd_solve.launches - launches0,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    print(json.dumps(res), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "torch_stream_classify.json"), "w") as f:
        json.dump(res, f, indent=1)
    ok = res["finite"] and res["counts_sum"] == done
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
