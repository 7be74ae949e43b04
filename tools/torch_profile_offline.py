"""The offline VI sweep on record 100 with hdpgpc_torch's phase timers
(the port's counterpart of tools/profile_offline.py).

Usage: python tools/torch_profile_offline.py [n_beats] [--warm]
       [--dtype float32] [--est-limit N] [--device cpu]

Prints the sweep count, the wall time and the phase table
(``print_timings``: seconds and calls by phase, each second counted
once, the card synchronised before each clock read). ``--warm`` first
runs ``warmup_programs`` and one untimed sweep on another model, so the
timed sweep pays no kernel build and no first-call library setup.
Without MIT-BIH data (HDPGPC_DATA_DIR) it sweeps synthetic beats of
record 100's shape instead, and says so. Runs on the card unless
``--device cpu``.
"""

import argparse
import contextlib
import io
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_beats", nargs="?", type=int, default=2272)
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--est-limit", type=int, default=0,
                    help="estimation_limit; 0: none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ["HDPGPC_TIMING"] = "1"
    from hdpgpc_torch.data.loader import default_x_basis, record_or_synthetic
    from hdpgpc_torch.data.priors import compute_estimators_lds
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.utils.eval import classification_error

    data, labels, synthetic = record_or_synthetic("100", lead=0,
                                                  beats=args.n_beats)
    if synthetic:
        print(f"no MIT-BIH record 100 (set HDPGPC_DATA_DIR): "
              f"synthetic_beats({data.shape[0]}, T=90, 4 clusters, seed 0) "
              "instead")
    std, std_dif, bound_sigma, bound_gamma = compute_estimators_lds(data)
    N, T, L = data.shape
    x_trains = np.tile(np.arange(T, dtype=np.float64), (N, 1))

    def build():
        # synthetic beats have no ECG baseline for the prior re-estimator
        return HDPGPC(default_x_basis(T), n_outputs=L, ini_lengthscale=3.0,
                      bound_lengthscale=(1.0, 20.0), ini_gamma=std_dif,
                      ini_sigma=std, ini_outputscale=300.0,
                      bound_sigma=bound_sigma, bound_gamma=bound_gamma,
                      verbose=False, hmm_switch=True, max_models=100,
                      bayesian_params=True,
                      reestimate_initial_params=not synthetic,
                      n_explore_steps=5, free_deg_MNIV=5,
                      estimation_limit=args.est_limit or None,
                      compute_dtype=args.dtype, device=args.device)

    if args.warm:
        warm = build()
        warm.warmup_programs(N)
        with contextlib.redirect_stdout(io.StringIO()):
            warm.include_batch(x_trains, data, with_warp=False)
        del warm   # timings are per model; the timed one starts clean
    model = build()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        model.include_batch(x_trains, data, with_warp=False)
    if model.device.type == "cuda":
        import torch
        torch.cuda.synchronize(model.device)
    elapsed = time.perf_counter() - t0
    sweeps = max(len(model.train_elbo), 1)
    err, tot = classification_error(model, labels, 0)
    print(f"total {elapsed:.1f}s, {sweeps} sweeps, "
          f"{elapsed / sweeps:.2f}s/sweep, err {err}/{tot}, M={model.M} "
          f"on {model.device}")
    model.print_timings()
    return model


if __name__ == "__main__":
    main()
