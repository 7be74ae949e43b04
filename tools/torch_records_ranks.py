"""The multi-record step over an n-rank process group against one
process (hdpgpc_torch.parallel.records; BASELINE config 4's layout over
cards).

Usage: python tools/torch_records_ranks.py [n_ranks] [--records R]
       [--beats N] [--device cpu]

Each rank takes a contiguous block of the R records (one card a rank,
NCCL; gloo with ``--device cpu``) and the ELBO is all-reduced; the same
step then runs in this process over all R records. Prints both wall
times, the ELBOs and whether resp and respPair are identical and q
agrees to 1e-9; exits non-zero if not. The records are
``entry.dryrun_inputs`` (random beats and labels, seed 0, T = 24,
K = 3) with the HDP theta update.
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
    ap.add_argument("n_ranks", nargs="?", type=int, default=4)
    ap.add_argument("--records", type=int, default=8)
    ap.add_argument("--beats", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from hdpgpc_torch.entry import dryrun_inputs, run_on_ranks
    from hdpgpc_torch.parallel import records

    kw = dict(hdp_update=True, trans_alpha=1.0, start_alpha=0.1, kappa=0.0)
    d = dryrun_inputs(args.records, N=args.beats)
    R, N, T = d["Y"].shape
    K = d["resp"].shape[2]
    t0 = time.perf_counter()
    out = run_on_ranks(args.n_ranks, d, device=args.device, **kw)
    t_ranks = time.perf_counter() - t0
    step = records.build_sharded_vi_step(T, K, device=args.device, **kw)
    t0 = time.perf_counter()
    q, q_lat, resp, respPair, elbo, _ = step(
        d["Y"], d["resp"], records.init_record_states(
            R, K, T, device=args.device), d["rho"], d["respPair"])
    if q.is_cuda:
        torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    same = (np.array_equal(out["resp"], resp.cpu().numpy())
            and np.array_equal(out["respPair"], respPair.cpu().numpy()))
    qd = float(np.max(np.abs(out["q"] - q.cpu().numpy()))
               / np.max(np.abs(q.cpu().numpy())))
    ed = float(np.max(np.abs(out["elbo"] - float(elbo))) / abs(float(elbo)))
    print(f"{args.n_ranks} ranks ({args.device}) x {R} records x {N} beats "
          f"x K {K}: {t_ranks:.2f} s with the ranks' start-up; one process "
          f"{t_one:.2f} s; ELBOs {out['elbo'].tolist()} vs {float(elbo)} "
          f"(rel {ed:.3e}); identical resp and respPair {same}; q rel "
          f"{qd:.3e}")
    if not (same and qd <= 1e-9 and ed <= 1e-9):
        raise SystemExit("the ranks disagree with one process")
    return out


if __name__ == "__main__":
    main()
