"""How many clusters the growth stress births on several growth streams:
the fused engine at K = 64 slots, T = 90, float32 on one CUDA card,
with the growth model of examples/torch_run_stress_stream.py
(estimation_limit=100, priors from the stream's first ``warm`` beats)
and its engine cadence (chunk 1024).

    python3 tools/torch_growth_regimes.py

Each stream is synthetic_growth_stream(n, 90, morphologies, seed=7,
start_beat=0, interval); a line per stream gives M, the beats at which
the births fell, the majority-label accuracy and the seconds, and the
whole goes to ``chiprun_out/torch_growth_regimes.json``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import runpy
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import hdpgpc_torch  # noqa: E402,F401  (sets the TF32 switches)
from hdpgpc_torch.data.loader import synthetic_growth_stream  # noqa: E402
from hdpgpc_torch.models.stream_online import OnlineStreamEngine  # noqa

# (beats, morphologies, interval, warm-up beats for the priors)
STREAMS = ((1536, 12, 128, 256), (1536, 12, 128, 128), (2048, 8, 256, 256),
           (3072, 12, 256, 256))
K, T = 64, 90


def main(argv=None):
    if not torch.cuda.is_available():
        print("torch_growth_regimes.py: no CUDA device", file=sys.stderr)
        return 2
    ex = runpy.run_path(os.path.join(ROOT, "examples",
                                     "torch_run_stress_stream.py"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    out = []
    for n, nc, interval, warm in STREAMS:
        y, z = synthetic_growth_stream(n, T, nc, seed=7, start_beat=0,
                                       interval=interval)
        eng = OnlineStreamEngine(ex["growth_model"](y[:warm], K, "cuda"),
                                 K=K, chunk=1024)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            eng.run(y)
        torch.cuda.synchronize()
        r = {"beats": n, "morphologies": nc, "interval": interval,
             "warm": warm, "M": int(eng.carry.M),
             "birth_beats": [i for i, b in enumerate(eng.births) if b],
             "accuracy": ex["majority_accuracy"](eng.uids, z),
             "seconds": time.perf_counter() - t0}
        print(json.dumps(r), flush=True)
        out.append(r)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "torch_growth_regimes.json"), "w") as f:
        json.dump({"card": card, "K": K, "T": T, "streams": out}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
