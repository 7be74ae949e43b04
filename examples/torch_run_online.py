"""Online streaming VI on one MIT-BIH record with hdpgpc_torch (the
port's counterpart of examples/run_online.py; reference
tests/test_online.py, test_online_warp.py with --warp).

Usage: python examples/torch_run_online.py [record] [--beats N] [--warp]
       [--device cpu]

Runs on the card unless ``--device cpu``. Without MIT-BIH data
(HDPGPC_DATA_DIR) it streams synthetic beats of the record's shape
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
    ap.add_argument("record", nargs="?", default="102")
    ap.add_argument("--beats", type=int, default=None)
    ap.add_argument("--lead", type=int, default=0)
    ap.add_argument("--warp", action="store_true")
    ap.add_argument("--estimation-limit", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fit-iters", type=int, default=None,
                    help="cap the kernel fits' Adam iterations")
    args = ap.parse_args(argv)

    from hdpgpc_torch.data.loader import default_x_basis, record_or_synthetic
    from hdpgpc_torch.data.priors import compute_estimators_lds
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.utils.eval import print_results

    data, labels, synthetic = record_or_synthetic(args.record, args.lead,
                                                  args.beats)
    if synthetic:
        print(f"no MIT-BIH record {args.record} (set HDPGPC_DATA_DIR): "
              f"streaming synthetic_beats({data.shape[0]}, T=90, 4 "
              "clusters, seed 0) instead")
    num_samples, T, L = data.shape
    # the priors from the first 30 beats (fewer in a shorter run)
    std, std_dif, bound_sigma, bound_gamma = compute_estimators_lds(
        data, min(30, num_samples - 2))
    noise_warp = std * 0.1

    x_basis = default_x_basis(T)
    x_train = np.arange(T, dtype=np.float64)
    sw_gp = HDPGPC(x_basis, n_outputs=L, model_type="dynamic",
                   ini_lengthscale=3.0, bound_lengthscale=(1.0, 20.0),
                   ini_gamma=std_dif, ini_sigma=std, ini_outputscale=300.0,
                   noise_warp=noise_warp,
                   bound_sigma=bound_sigma, bound_gamma=bound_gamma,
                   bound_noise_warp=(noise_warp * 0.1, noise_warp * 0.2),
                   method_compute_warp="greedy", verbose=False,
                   hmm_switch=True, max_models=100,
                   bayesian_params=True,
                   estimation_limit=args.estimation_limit,
                   free_deg_MNIV=20, device=args.device,
                   kernel_fit_iters=args.fit_iters)
    sw_gp.warp = args.warp
    t0 = time.time()
    for i in range(data.shape[0]):
        t1 = time.time()
        sw_gp.include_sample(x_train, data[i], with_warp=args.warp)
        print(f"Sample: {i} / {data.shape[0] - 1} label: {labels[i]} "
              f"--- {time.time() - t1:.3f} seconds ---")
    print("Time --- %s mins ---" % str((time.time() - t0) / 60.0))
    print_results(sw_gp, labels, 0)
    return sw_gp


if __name__ == "__main__":
    main()
