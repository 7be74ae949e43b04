"""Non-ECG use case with hdpgpc_torch: clustering ocean wave spectra
(the port's counterpart of examples/run_ocean.py; the reference's
test_step_ocean.ipynb tutorial domain).

Usage: python examples/torch_run_ocean.py [--n N] [--regimes R]
       [--freq freq.npy] [--dtype float64] [--device cpu]

The reference ships only the 171-point frequency axis (data/ocean/
freq.npy; ``--freq``), not the spectra, so this driver synthesises
JONSWAP-like spectra with regime switches on that axis, or on a
171-point axis of its own without one, and says so. The spectra need
lengthscales far below ECG's (0.02 on the frequency axis). Runs on the
card unless ``--device cpu``.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def jonswap_like(freq, hs, tp, gamma=3.3):
    """Simplified JONSWAP spectral shape."""
    fp = 1.0 / tp
    sigma = np.where(freq <= fp, 0.07, 0.09)
    r = np.exp(-((freq - fp) ** 2) / (2 * sigma**2 * fp**2))
    alpha = 5.0 / 16.0 * hs**2 * fp**4
    with np.errstate(divide="ignore", over="ignore"):
        s = alpha * freq**-5 * np.exp(-1.25 * (fp / freq) ** 4) * gamma**r
    return np.nan_to_num(s, posinf=0.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--regimes", type=int, default=3)
    ap.add_argument("--freq", default=None,
                    help="the reference's data/ocean/freq.npy")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fit-iters", type=int, default=None,
                    help="cap the kernel fits' Adam iterations")
    args = ap.parse_args(argv)

    if args.freq and os.path.exists(args.freq):
        freq = np.load(args.freq).astype(np.float64).reshape(-1)
    else:
        freq = np.linspace(0.03, 0.5, 171)
        print("no frequency axis (--freq): synthetic spectra on a "
              "171-point axis over [0.03, 0.5]")
    T = freq.shape[0]

    rng = np.random.default_rng(0)
    params = [(1.5 + 2.5 * k, 6.0 + 4.0 * k) for k in range(args.regimes)]
    z = np.repeat(np.arange(args.regimes),
                  args.n // args.regimes + 1)[: args.n]
    rng.shuffle(z)
    spectra = np.stack([
        jonswap_like(freq, *params[zi]) * (1 + 0.08 * rng.standard_normal(T))
        for zi in z])[:, :, None]

    from hdpgpc_torch.data.priors import compute_estimators_lds
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.utils.eval import print_results

    std, std_dif, bs, bg = compute_estimators_lds(spectra)
    x_basis = np.atleast_2d(freq).T
    # the prior re-estimator reads the first 10 samples as an ECG
    # baseline; spectra are ~0 there, so the constructor's estimates stay
    m = HDPGPC(x_basis, n_outputs=1, ini_lengthscale=0.02,
               bound_lengthscale=(0.005, 0.2), ini_gamma=std_dif,
               ini_sigma=std, ini_outputscale=float(np.var(spectra)),
               bound_sigma=bs, bound_gamma=bg,
               reestimate_initial_params=False, n_explore_steps=5,
               compute_dtype=args.dtype, device=args.device,
               kernel_fit_iters=args.fit_iters)
    x_trains = np.tile(freq, (args.n, 1))
    t0 = time.time()
    m.include_batch(x_trains, spectra, with_warp=False)
    print("OCEAN: %.1fs, clusters=%d" % (time.time() - t0, m.M))
    print_results(m, z, 0)
    return m


if __name__ == "__main__":
    main()
