"""The warped two-lead sweep of chip_smoke.py's ``warp`` phase, on a
prefix of its beats, in hdpgpc_tpu and in hdpgpc_torch on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_warp_prefix.py [--beats 200]
        [--dtype float32] [--sweeps 2]

Both packages get the same beats (synthetic_beats(2272, T=90, 4
morphologies, 2 leads, noise 0.05, seed 0), cut to the first --beats)
and chip_smoke.py's configuration (estimation_limit=1000, the warp noise
from the data). Prints, for each package, the sweeps, M, the error
against the generating labels and the seconds; then whether the
partitions are identical in every sweep and the largest relative ELBO
difference. A monotone warp can pull one bump onto another's template,
so the error is what the reference gives, not a gate.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--beats", type=int, default=200)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--sweeps", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from hdpgpc_torch.models.hdpgpc import HDPGPC as TorchHDPGPC
    from hdpgpc_torch.utils.eval import classification_error
    from hdpgpc_tpu.models.hdpgpc import HDPGPC as JaxHDPGPC

    y, z = chip_smoke._warp_beats()
    y, z = y[:args.beats], z[:args.beats]
    x = np.tile(np.arange(y.shape[1], dtype=np.float64), (y.shape[0], 1))
    runs = {}
    for name, cls in (("hdpgpc_tpu", JaxHDPGPC),
                      ("hdpgpc_torch (cpu)", TorchHDPGPC)):
        m = chip_smoke._warp_model(cls, y, chip_smoke.SLICE_EST_LIMIT,
                                   args.dtype, "cpu")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            m.include_batch(x, y, it_limit=args.sweeps, with_warp=True)
        secs = time.perf_counter() - t0
        err, tot = classification_error(m, z)
        runs[name] = m
        print(f"{name}: {args.beats} beats x {y.shape[2]} leads, "
              f"{args.dtype}, sweeps {len(m.train_elbo)}, M {m.M}, error "
              f"{err}/{tot}, {secs:.1f} s", flush=True)
    a, b = runs.values()
    same, rel = chip_smoke._same_sweeps(np, b, a)
    print(f"identical partitions {same}, max ELBO rel diff {rel:.3e} "
          f"(torch {torch.__version__})")


if __name__ == "__main__":
    main()
