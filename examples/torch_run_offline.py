"""Offline batch VI on one MIT-BIH record with hdpgpc_torch (the port's
counterpart of examples/run_offline.py; reference tests/test_offline.py).

Usage: python examples/torch_run_offline.py [record] [--beats N]
       [--lead L] [--warp] [--dtype float32] [--device cpu] [--out PNG]

Runs on the card unless ``--device cpu``. Without MIT-BIH data
(HDPGPC_DATA_DIR) it clusters synthetic beats of the record's shape
instead, and says so.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("record", nargs="?", default="100")
    ap.add_argument("--beats", type=int, default=None)
    ap.add_argument("--lead", type=int, default=0)
    ap.add_argument("--warp", action="store_true")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fit-iters", type=int, default=None,
                    help="cap the kernel fits' Adam iterations")
    ap.add_argument("--out", default=None,
                    help="save the cluster panels to this PNG")
    args = ap.parse_args(argv)

    from hdpgpc_torch.data.loader import default_x_basis, record_or_synthetic
    from hdpgpc_torch.data.priors import compute_estimators_lds
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.utils.eval import print_results

    data, labels, synthetic = record_or_synthetic(args.record, args.lead,
                                                  args.beats)
    if synthetic:
        print(f"no MIT-BIH record {args.record} (set HDPGPC_DATA_DIR): "
              f"clustering synthetic_beats({data.shape[0]}, T=90, 4 "
              "clusters, seed 0) instead")
    num_samples, T, L = data.shape
    std, std_dif, bound_sigma, bound_gamma = compute_estimators_lds(data)
    noise_warp = std * 0.1

    x_basis = default_x_basis(T)
    x_trains = np.tile(np.arange(T, dtype=np.float64), (num_samples, 1))
    # synthetic beats have no ECG baseline for the prior re-estimator
    # (GPI_HDP.py:1876-1880) to read
    sw_gp = HDPGPC(x_basis, n_outputs=L, model_type="dynamic",
                   ini_lengthscale=3.0, bound_lengthscale=(1.0, 20.0),
                   ini_gamma=std_dif, ini_sigma=std, ini_outputscale=300.0,
                   noise_warp=noise_warp,
                   bound_sigma=bound_sigma, bound_gamma=bound_gamma,
                   bound_noise_warp=(noise_warp * 0.1, noise_warp * 0.2),
                   method_compute_warp="greedy", verbose=False,
                   hmm_switch=True, max_models=100, mode_warp="rough",
                   bayesian_params=True,
                   reestimate_initial_params=not synthetic,
                   n_explore_steps=5, free_deg_MNIV=5,
                   compute_dtype=args.dtype, device=args.device,
                   kernel_fit_iters=args.fit_iters)
    t0 = time.time()
    sw_gp.include_batch(x_trains, data, with_warp=args.warp)
    print("Time --- %s mins ---" % str((time.time() - t0) / 60.0))
    main_model = print_results(sw_gp, labels, 0)
    if args.out:
        from hdpgpc_torch.utils.plots import plot_models_plotly
        plot_models_plotly(sw_gp, sw_gp.selected_gpmodels(), main_model,
                           labels, 0, lead=0, save=args.out, step=0.5,
                           plot_latent=True)
        print("saved", args.out)
    return sw_gp


if __name__ == "__main__":
    main()
