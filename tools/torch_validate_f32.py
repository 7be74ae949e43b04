"""float32 against float64 on every record, with hdpgpc_torch (the
port's counterpart of tools/validate_f32.py).

Per record it runs the offline VI sweep (the reference test_offline.py
configuration, lead 0, warp off) in float64 and in float32 (the speed
mode, at ``--est-limit``) and reports each arm's cluster count M and
classification error, and the adjusted Rand index between the two hard
partitions.

    python tools/torch_validate_f32.py --arm f64      # one arm
    python tools/torch_validate_f32.py --arm f32
    python tools/torch_validate_f32.py --merge        # ARIs + markdown
    python tools/torch_validate_f32.py                # all three

Each arm is resumable: it writes ``arm_<arm>.json`` and the partitions
``arm_<arm>_assignments.npz`` under ``--out-dir`` (default
chiprun_out/) after every record. ``--merge`` writes
``f32_validation.json`` and ``f32_validation.md`` there. The records
are those of the MIT-BIH data directory (HDPGPC_DATA_DIR); without one,
``--synthetic R`` synthetic records (record i: synthetic_beats of
record 100's shape, seed i), which the output says. Runs on the card
unless ``--device cpu``.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _atomic_json(path, obj):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _atomic_npz(path, arrays):
    # suffix .npz, or numpy appends it and leaves the temp name behind
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz")
    os.close(fd)
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def _load_json(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _load_npz(path):
    return dict(np.load(path)) if os.path.exists(path) else {}


def assignments(model):
    """Per-beat hard cluster id from the model's member sets."""
    out = np.full(model.T_count, -1, np.int64)
    for m, idx in enumerate(model.member_indexes()):
        out[idx] = m
    return out


def run_one(rec, seed, beats, dtype, est_limit, device, fit_iters=None):
    from hdpgpc_torch.data.loader import default_x_basis, record_or_synthetic
    from hdpgpc_torch.data.priors import compute_estimators_lds
    from hdpgpc_torch.models.hdpgpc import HDPGPC
    from hdpgpc_torch.utils.eval import classification_error

    data, labels, synthetic = record_or_synthetic(rec, lead=0, beats=beats,
                                                  seed=seed)
    std, std_dif, bs, bg = compute_estimators_lds(data)
    N, T, L = data.shape
    x = np.tile(np.arange(T, dtype=np.float64), (N, 1))
    # synthetic beats have no ECG baseline for the prior re-estimator
    m = HDPGPC(default_x_basis(T), n_outputs=L, ini_gamma=std_dif,
               ini_sigma=std, ini_outputscale=300.0, bound_sigma=bs,
               bound_gamma=bg, reestimate_initial_params=not synthetic,
               n_explore_steps=5, compute_dtype=dtype,
               estimation_limit=est_limit, kernel_fit_iters=fit_iters,
               device=device)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        m.include_batch(x, data, with_warp=False)
    err, tot = classification_error(m, labels, 0)
    r = {"M": int(m.M), "err": int(err), "tot": int(tot),
         "sec": round(time.time() - t0, 1), "device": str(m.device),
         "synthetic": synthetic}
    if dtype == "float32":
        # the f32 fragility guard: the narrowest decision margin
        mrm = m.f32_min_rel_margin
        r["guard_min_rel_margin"] = (None if mrm == float("inf")
                                     else float(f"{mrm:.3e}"))
        r["guard_fragile"] = bool(m.f32_fragile)
    return r, assignments(m)


def _records(args):
    from hdpgpc_torch.data.loader import list_records
    if args.records:
        return args.records.split(",")
    try:
        return list_records()
    except FileNotFoundError:
        print(f"no MIT-BIH data (set HDPGPC_DATA_DIR): {args.synthetic} "
              "synthetic records (synthetic_beats, record i from seed i) "
              "instead", flush=True)
        return [f"synthetic{i}" for i in range(args.synthetic)]


def arm_paths(out_dir, arm):
    stem = os.path.join(out_dir, f"arm_{arm}")
    return stem + ".json", stem + "_assignments.npz"


def run_arm(arm, args):
    """One dtype arm over the records, resumable, its own files."""
    out, asg_path = arm_paths(args.out_dir, arm)
    results, asg = _load_json(out), _load_npz(asg_path)
    dtype = "float64" if arm == "f64" else "float32"
    # the f64 arm runs exact (no limit), the f32 arm at the speed mode's
    est = None if arm == "f64" else (args.est_limit or None)
    for i, rec in enumerate(_records(args)):
        key = f"{rec}@{args.beats or 'full'}"
        if key in results and key in asg and not args.force:
            print(f"{key}: done", flush=True)
            continue
        r, a = run_one(rec, i, args.beats, dtype, est, args.device,
                       args.fit_iters)
        results[key] = r
        asg[key] = np.asarray(a, np.int16)
        _atomic_json(out, results)
        _atomic_npz(asg_path, asg)
        print(f"[{arm}] rec {rec}: M {r['M']} err {r['err']}/{r['tot']} "
              f"({r['sec']}s, {r['device']})", flush=True)


def merge(args):
    """Both arms' results per record and the ARI between their
    partitions, as JSON and markdown."""
    from hdpgpc_torch.utils.eval import adjusted_rand_index
    (j64, a64), (j32, a32) = [
        (_load_json(j), _load_npz(a))
        for j, a in (arm_paths(args.out_dir, "f64"),
                     arm_paths(args.out_dir, "f32"))]
    combined = {}
    for key in sorted(set(j64) & set(j32)):
        combined[key] = {"f64": j64[key], "f32": j32[key],
                         "ari": round(float(adjusted_rand_index(
                             a64[key], a32[key])), 6)}
    _atomic_json(os.path.join(args.out_dir, "f32_validation.json"),
                 combined)
    lines = [
        f"# float32 against float64, per record (est{args.est_limit} in "
        "float32)",
        "",
        "Offline VI (reference test_offline.py configuration, lead 0, warp",
        "off) with hdpgpc_torch in float64 (no estimation limit) and in",
        "float32. ARI = adjusted Rand index between the two final hard",
        "partitions. Written by tools/torch_validate_f32.py.",
        "",
        "| rec | beats | M f64 | M f32 | err f64 | err f32 | ARI | guard "
        "| s f64 | s f32 | device |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for key, r in combined.items():
        f64, f32 = r["f64"], r["f32"]
        guard = "FLAG" if f32.get("guard_fragile") else "ok"
        syn = " (synthetic)" if f64.get("synthetic") else ""
        lines.append(
            f"| {key.split('@')[0]}{syn} | {f64['tot']} | {f64['M']} | "
            f"{f32['M']} | {f64['err']}/{f64['tot']} | "
            f"{f32['err']}/{f32['tot']} | {r['ari']:.4f} | {guard} | "
            f"{f64['sec']} | {f32['sec']} | {f32['device']} |")
    if combined:
        aris = [r["ari"] for r in combined.values()]
        lines += ["", f"**{len(aris)} records; mean ARI "
                      f"{sum(aris) / len(aris):.4f}.**"]
    md = os.path.join(args.out_dir, "f32_validation.md")
    with open(md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {md} ({len(combined)} records)")
    return combined


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", default=None)
    ap.add_argument("--synthetic", type=int, default=48,
                    help="synthetic records to run without MIT-BIH data")
    ap.add_argument("--beats", type=int, default=None,
                    help="cap beats per record (default: full record)")
    ap.add_argument("--est-limit", type=int, default=300,
                    help="estimation_limit of the float32 arm; 0: none")
    ap.add_argument("--arm", choices=["f64", "f32"], default=None)
    ap.add_argument("--merge", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="re-run records an arm has done")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "chiprun_out"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fit-iters", type=int, default=None,
                    help="cap the kernel fits' Adam iterations")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.merge:
        return merge(args)
    if args.arm:
        return run_arm(args.arm, args)
    run_arm("f64", args)
    run_arm("f32", args)
    return merge(args)


if __name__ == "__main__":
    main()
