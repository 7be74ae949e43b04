"""Long-horizon streaming stress through hdpgpc_torch (the port's
counterpart of examples/run_stress_stream.py; BASELINE config 5: 1M
synthetic beats, K = 64, T = 90, float32).

Two modes, as the example's:

* default (fixed-K classification): the frozen-cluster classifier
  (models/streaming.py) with all K morphologies known up front, at a
  fixed memory. Its templates are the class means of a 50 K-beat
  warm-up; warm-up and stream come from ONE seeded synthetic_beats call
  (synthetic_beats draws its morphologies from the seed, so the
  example's templates of seed 0 and blocks of seed 1 + done hold other
  morphologies). The chunk is the smaller of ``--chunk`` and what the
  free memory holds (models/streaming.stream_chunk).
* ``--grow`` (growth stress): the fused online engine
  (models/stream_online.OnlineStreamEngine) on a stream that starts with
  one morphology and brings a new one every ``beats / K`` beats; the
  clusters are born into a fixed bank of K slots, the LDS updates freeze
  past the estimation limit (100), and the carry's memory stays
  constant. The model is the example's: priors from the first 256 beats,
  float32, at most K clusters; the engine refreshes the HDP globals on
  the host every ``min(--chunk, 1024)`` beats, the example's cadence.

Both stream in generation blocks of 65,536 beats; beats/s is taken after
the first block (over all beats when there is one block). Each prints
the card's name and power limit, a line per four blocks and its result
(beats/s, accuracy, M, births, the seconds of the kernel fits, kernel-B
launches per beat, peak memory: ``torch.cuda.max_memory_allocated`` on
the card, and the process's peak RSS).

Usage: python examples/torch_run_stress_stream.py [--beats 1000000]
           [--k 64] [--t 90] [--chunk 8192] [--grow] [--log PATH]
           [--json PATH] [--device cpu] [--fit-iters N]

Runs on the card unless ``--device cpu``. ``--log`` (``--grow``) appends
a JSON line per four blocks and one at the end; ``--json`` writes the
result.
"""

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BLOCK = 65536


def _card(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return smi.stdout.strip()


def _peak_rss_mb() -> float:
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                 / 1024.0, 1)


def _peak_device_bytes(torch, dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def growth_model(warm, K, device, fit_iters=None):
    """The growth stress model of examples/run_stress_stream.py:68-82:
    priors from the warm-up beats ``warm`` (n, T), estimation_limit=100,
    at most K clusters, float32."""
    from hdpgpc_torch.data.loader import default_x_basis
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    std = float(np.std(warm))
    std_dif = float(np.std(np.diff(warm, axis=0)))
    return HDPGPC(default_x_basis(warm.shape[1]), n_outputs=1,
                  ini_lengthscale=3.0, bound_lengthscale=(1.0, 20.0),
                  ini_gamma=std_dif, ini_sigma=std, ini_outputscale=4.0,
                  bound_sigma=(std * 0.05, std * 0.2),
                  bound_gamma=(std_dif * 0.05, std_dif * 0.2),
                  verbose=False, hmm_switch=True, max_models=K,
                  bayesian_params=True, estimation_limit=100,
                  free_deg_MNIV=5, compute_dtype="float32", device=device,
                  kernel_fit_iters=fit_iters)


def majority_accuracy(uids, z) -> float:
    """The share of beats whose cluster's majority generating label is
    their own."""
    uids, z = np.asarray(uids), np.asarray(z)
    correct = sum(int(np.bincount(z[uids == u]).max())
                  for u in np.unique(uids))
    return correct / max(len(z), 1)


def run_grow(args, torch, dev):
    from hdpgpc_torch.data.loader import synthetic_growth_stream
    from hdpgpc_torch.models.stream_online import OnlineStreamEngine
    from hdpgpc_torch.ops.spd_solve import spd_solve

    K, T = args.k, args.t
    interval = max(args.beats // K, 1)
    warm, _ = synthetic_growth_stream(256, T, K, seed=7, start_beat=0,
                                      interval=interval)
    model = growth_model(warm, K, dev, args.fit_iters)
    eng = OnlineStreamEngine(model, K=K, chunk=min(args.chunk, 1024))

    def _log(obj):
        if args.log:
            with open(args.log, "a") as f:
                f.write(json.dumps(obj) + "\n")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = spd_solve.launches
    done, done0, z_all = 0, 0, []
    t_start = time.perf_counter()
    t0 = None
    while done < args.beats:
        n = min(BLOCK, args.beats - done)
        y, z = synthetic_growth_stream(n, T, K, seed=100 + done,
                                       start_beat=done, interval=interval)
        eng.run(y, hdp_refresh=True)
        _sync(torch, dev)
        z_all.append(z)
        if t0 is None:
            # steady state after the first block; one block keeps it
            t0, done0 = time.perf_counter(), n
            if args.beats <= BLOCK:
                t0, done0 = t_start, 0
        done += n
        if done % (BLOCK * 4) < BLOCK:
            dt = max(time.perf_counter() - t0, 1e-9)
            M = int(eng.carry.M)
            print(f"{done}/{args.beats} beats  {(done - done0) / dt:.1f} "
                  f"beats/s  M={M}", flush=True)
            _log({"beats": done, "of": args.beats, "K": K, "M": M,
                  "beats_per_sec": round((done - done0) / dt, 1),
                  "peak_rss_mb": _peak_rss_mb(),
                  "peak_device_bytes": _peak_device_bytes(torch, dev)})
    dt = max(time.perf_counter() - t0, 1e-9)
    M = int(eng.carry.M)
    res = {"mode": "grow", "card": args.card, "K": K, "T": T,
           "dtype": "float32", "beats": done, "chunk": eng.chunk,
           "clusters_born": M, "births": int(sum(eng.births)),
           "beats_per_sec": (done - done0) / dt, "seconds_timed": dt,
           "accuracy": majority_accuracy(eng.uids, np.concatenate(z_all)),
           "kernel_fits": eng.step.fits,
           "kernel_fit_seconds": eng.step.fit_seconds,
           "kernel_b_per_beat": (spd_solve.launches - launches0) / done,
           "q_sel_sum": float(eng.carry.q_sel_sum),
           "qlat_sel_sum": float(eng.carry.qlat_sel_sum),
           "peak_device_bytes": _peak_device_bytes(torch, dev),
           "peak_rss_mb": _peak_rss_mb()}
    res["ok"] = bool(1 <= M <= K and np.isfinite(res["q_sel_sum"])
                     and np.isfinite(res["qlat_sel_sum"]))
    print(f"GROWTH STRESS DONE: {done} beats, K_slots={K}, "
          f"clusters_born={M}, {res['beats_per_sec']:.1f} beats/s, "
          f"acc={res['accuracy']:.4f}, {dt / 60:.1f} min (steady state, "
          f"first block excluded), kernel fits {res['kernel_fits']} in "
          f"{res['kernel_fit_seconds']:.1f} s, kernel B "
          f"{res['kernel_b_per_beat']:.3f} a beat, peak device memory "
          f"{res['peak_device_bytes']} bytes, peak_rss="
          f"{res['peak_rss_mb']} MB", flush=True)
    _log(dict(event="done", **res))
    return res


def run_classify(args, torch, dev):
    from hdpgpc_torch.data.loader import synthetic_beats
    from hdpgpc_torch.models import streaming
    from hdpgpc_torch.ops.spd_solve import spd_solve

    K, T = args.k, args.t
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
    chunk = min(args.chunk, streaming.stream_chunk(
        K, T, torch.float32, streaming.free_memory(dev)))
    print(f"K {K}, T {T}, float32, {args.beats} beats, chunk {chunk}",
          flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    correct, done, t0, t_warm = 0, 0, None, None
    launches0 = spd_solve.launches
    while done < args.beats:
        n = min(BLOCK, args.beats - done)
        st, lab = streaming.stream_classify(st, Y[done:done + n],
                                            chunk=chunk)
        correct += int(np.sum(lab == z[done:done + n]))
        done += n
        _sync(torch, dev)
        if t0 is None:
            t0, t_warm = time.perf_counter(), done
        elif (done // BLOCK) % 4 == 0:
            dt = time.perf_counter() - t0
            print(f"{done}/{args.beats} beats  {(done - t_warm) / dt:.1f} "
                  f"beats/s  acc={correct / done:.4f}", flush=True)
    dt = time.perf_counter() - t0
    timed = done - t_warm
    res = {"mode": "classify", "card": args.card, "K": K, "T": T,
           "dtype": "float32", "beats": done, "chunk": chunk,
           "beats_per_s": timed / dt if timed else None,
           "seconds_timed": dt, "beats_timed": timed,
           "accuracy": correct / done,
           "counts_sum": float(st.counts.sum()),
           "finite": all(bool(torch.isfinite(v).all()) for v in st),
           "kernel_b_launches": spd_solve.launches - launches0,
           "peak_memory_bytes": _peak_device_bytes(torch, dev),
           "peak_rss_mb": _peak_rss_mb()}
    res["ok"] = res["finite"] and res["counts_sum"] == done
    print(f"STRESS DONE: {done} beats, K={K}, "
          f"{res['beats_per_s']} beats/s after the first block, acc="
          f"{res['accuracy']:.4f}, {dt / 60:.1f} min", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--beats", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--t", type=int, default=90)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--grow", action="store_true",
                    help="full online VI with births into K slots")
    ap.add_argument("--log", default=None,
                    help="(--grow) append JSON progress/result lines here")
    ap.add_argument("--json", default=None, help="write the result here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fit-iters", type=int, default=None,
                    help="(--grow) cap the kernel fits' Adam iterations")
    args = ap.parse_args(argv)

    import torch

    import hdpgpc_torch  # noqa: F401  (sets the TF32 switches)
    from hdpgpc_torch.device import resolve_device
    dev = resolve_device(args.device)
    args.card = _card(dev)
    print(args.card, flush=True)
    res = (run_grow if args.grow else run_classify)(args, torch, dev)
    print(json.dumps(res), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
