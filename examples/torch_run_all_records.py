"""Full MIT-BIH sweep with hdpgpc_torch: offline VI on every record (the
port's counterpart of examples/run_all_records.py, BASELINE config 4).

Usage: python examples/torch_run_all_records.py [--beats N]
       [--records 100,101] [--devices D] [--device cpu]

Each record's VI search is independent (embarrassingly parallel across
records). Two execution modes:

* default: the records one after another on one device;
* ``--devices D``: records run concurrently, one worker thread per card,
  each pinned to its card with ``torch.cuda.device`` (record i on card
  i mod D; with ``--device cpu``, D threads on the CPU). The per-record
  search (births, accept/reject) diverges between records, so a device
  per record is the layout for the full algorithm; the lockstep
  fixed-assignment step over records is
  hdpgpc_torch/parallel/records.py. Results equal the sequential
  mode's (same per-record algorithm, same seeds).

The records are ``list_records()`` of the MIT-BIH data directory
(HDPGPC_DATA_DIR); without one, ``--synthetic R`` synthetic records
(record i: synthetic_beats of record 100's shape, seed i), which the
output says. Runs on the card unless ``--device cpu``.
"""

import argparse
import contextlib
import io
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class _MainThreadOnlyStdout:
    """stdout proxy that drops writes from worker threads (a redirect
    swaps sys.stdout for the whole process, so concurrent records would
    hijack each other's prints)."""

    def __init__(self, real):
        self._real = real
        self._main = threading.main_thread().ident

    def write(self, s):
        if threading.get_ident() == self._main:
            self._real.write(s)
        return len(s)

    def flush(self):
        if threading.get_ident() == self._main:
            self._real.flush()


def _sweep_record(rec, seed, beats, hdp, device, dtype, fit_iters,
                  quiet_redirect=True):
    import numpy as np
    import torch

    from hdpgpc_torch.data.loader import default_x_basis, record_or_synthetic
    from hdpgpc_torch.data.priors import compute_estimators_lds
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.utils.eval import classification_error

    dev = torch.device(device)
    ctx = torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()
    with ctx:
        data, labels, synthetic = record_or_synthetic(rec, lead=0,
                                                      beats=beats, seed=seed)
        std, std_dif, bs, bg = compute_estimators_lds(data)
        N, T, L = data.shape
        x = np.tile(np.arange(T, dtype=np.float64), (N, 1))
        # synthetic beats have no ECG baseline for the prior re-estimator
        m = HDPGPC(default_x_basis(T), n_outputs=L, ini_gamma=std_dif,
                   ini_sigma=std, ini_outputscale=300.0, bound_sigma=bs,
                   bound_gamma=bg, reestimate_initial_params=not synthetic,
                   n_explore_steps=5, hdp_hyp=hdp, compute_dtype=dtype,
                   kernel_fit_iters=fit_iters, device=dev)
        t0 = time.time()
        redir = contextlib.redirect_stdout(io.StringIO()) \
            if quiet_redirect else contextlib.nullcontext()
        with redir:
            m.include_batch(x, data, with_warp=False)
        err, tot = classification_error(m, labels, 0)
        return rec, N, m.M, err, tot, time.time() - t0, synthetic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--beats", type=int, default=None)
    ap.add_argument("--records", default=None)
    ap.add_argument("--synthetic", type=int, default=48,
                    help="synthetic records to sweep without MIT-BIH data")
    ap.add_argument("--hdp", default="balanced")
    ap.add_argument("--dtype", default="float64",
                    help="compute dtype; float32 is the speed mode")
    ap.add_argument("--devices", type=int, default=None,
                    help="run records concurrently on this many cards")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fit-iters", type=int, default=None,
                    help="cap the kernel fits' Adam iterations")
    args = ap.parse_args(argv)

    from hdpgpc_torch.data.loader import list_records
    from hdpgpc_torch.device import resolve_device

    if args.records:
        recs = args.records.split(",")
    else:
        try:
            recs = list_records()
        except FileNotFoundError:
            recs = [f"synthetic{i}" for i in range(args.synthetic)]
            print(f"no MIT-BIH data (set HDPGPC_DATA_DIR): sweeping "
                  f"{args.synthetic} synthetic records (synthetic_beats, "
                  "record i from seed i) instead", flush=True)
    base = resolve_device(args.device)
    t_all = time.time()
    results = []

    def report(r):
        results.append(r)
        rec, N, M, err, tot, dt, synthetic = r
        print(f"rec {rec}{' (synthetic beats)' if synthetic else ''}: "
              f"N={N} clusters={M} err={err}/{tot} ({err / tot:.4f}) in "
              f"{dt:.1f}s", flush=True)

    common = (args.beats, args.hdp)
    tail = (args.dtype, args.fit_iters)
    if args.devices:
        D = args.devices
        if base.type == "cuda":
            import torch
            if torch.cuda.device_count() < D:
                raise RuntimeError(f"--devices {D}: torch sees "
                                   f"{torch.cuda.device_count()} cards")
            devs = [f"cuda:{i}" for i in range(D)]
        else:
            devs = ["cpu"] * D
        print(f"concurrent mode: {D} workers on {', '.join(devs)}")

        def worker(i_rec):
            i, rec = i_rec
            return _sweep_record(rec, i, *common, devs[i % D], *tail,
                                 quiet_redirect=False)

        real = sys.stdout
        sys.stdout = _MainThreadOnlyStdout(real)
        try:
            with ThreadPoolExecutor(max_workers=D) as ex:
                for r in ex.map(worker, enumerate(recs)):
                    report(r)
        finally:
            sys.stdout = real
    else:
        for i, rec in enumerate(recs):
            report(_sweep_record(rec, i, *common, str(base), *tail))

    total_err = sum(r[3] for r in results)
    total_beats = sum(r[4] for r in results)
    print(f"TOTAL: {total_err}/{total_beats} "
          f"({total_err / max(total_beats, 1):.4f}) "
          f"in {(time.time() - t_all) / 60:.1f} min")
    return results


if __name__ == "__main__":
    main()
