"""Supervised reload and classification of a new batch with hdpgpc_torch
(the port's counterpart of examples/run_reload_classify.py; reference
tests/test_offline_multi_output_load.py).

Usage: python examples/torch_run_reload_classify.py [record] [--train N]
       [--test M] [--learning] [--device cpu]

Runs on the card unless ``--device cpu``. Without MIT-BIH data
(HDPGPC_DATA_DIR) it takes synthetic beats of the record's shape (both
leads) and their generating labels instead, and says so.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("record", nargs="?", default="100")
    ap.add_argument("--train", type=int, default=500)
    ap.add_argument("--test", type=int, default=100)
    ap.add_argument("--learning", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fit-iters", type=int, default=None,
                    help="cap the kernel fits' Adam iterations")
    args = ap.parse_args(argv)

    from hdpgpc_torch.data.loader import default_x_basis, record_or_synthetic
    from hdpgpc_torch.data.priors import compute_estimators_lds
    from hdpgpc_torch.models.hdpgpc import HDPGPC

    data, labels, synthetic = record_or_synthetic(
        args.record, beats=args.train + args.test)    # both leads
    if synthetic:
        print(f"no MIT-BIH record {args.record} (set HDPGPC_DATA_DIR): "
              f"synthetic_beats({data.shape[0]}, T=90, 4 clusters, 2 "
              "leads, seed 0) and their labels instead")
    y_tr = data[:args.train]
    lab_tr = labels[:args.train]
    y_te = data[args.train:args.train + args.test]
    lab_te = labels[args.train:args.train + args.test]

    classes, int_tr = np.unique(lab_tr, return_inverse=True)
    M = classes.shape[0]
    N, T, L = y_tr.shape
    std, std_dif, bs, bg = compute_estimators_lds(y_tr)
    x = np.tile(np.arange(T, dtype=np.float64), (N, 1))

    model = HDPGPC(default_x_basis(T), n_outputs=L, ini_gamma=std_dif,
                   ini_sigma=std, ini_outputscale=300.0, bound_sigma=bs,
                   bound_gamma=bg, reestimate_initial_params=False,
                   device=args.device,
                   kernel_fit_iters=args.fit_iters)
    model.reload_model_from_labels(x, y_tr, int_tr, M=M)
    x_te = np.tile(np.arange(T, dtype=np.float64), (y_te.shape[0], 1))
    pred = model.cluster_new_batch(x_te, y_te, learning=args.learning)
    pred_labels = classes[np.clip(pred, 0, M - 1)]
    acc = float(np.mean(pred_labels == lab_te))
    print(f"Classified {y_te.shape[0]} new beats; accuracy vs annotations: "
          f"{acc:.4f}")
    for c in classes:
        n = int(np.sum(lab_te == c))
        if n:
            a = float(np.mean(pred_labels[lab_te == c] == c))
            print(f"  class {c}: n={n} acc={a:.3f}")
    return acc


if __name__ == "__main__":
    main()
