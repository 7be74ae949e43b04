"""Where kernel B's time goes inside one launch, on one CUDA card.

    python3 tools/kernel_b_phases.py [--shapes 16,90,90 16,90,1 ...]

Builds a copy of ``hdpgpc_torch/csrc/spd_solve.cu`` in which thread 0 of
block 0 reads ``clock64()`` after every block barrier, runs it at each
shape (n, T, R) in float32 and float64, and prints the SM cycles of
each phase of that block, summed by kind: the load of the system, per
panel the diagonal block's factor (one warp), its inverse, the panel
solve and the trailing update, then the right-hand-side load, the
substitution products and the store. The copy's results are not used;
the shipped kernel is untouched. Shapes must keep the system in shared
memory (T <= 192 in float32, T <= 128 in float64).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from collections import OrderedDict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hdpgpc_torch  # noqa: E402,F401  (sets the TF32 switches)
from hdpgpc_torch.ops import _build  # noqa: E402

_SLOTS = 256
_STAMP = ("if (blockIdx.x == 0 && threadIdx.x == 0 && g_np < "
          f"{_SLOTS}) g_prof[g_np++] = clock64();")


def build() -> ctypes.CDLL:
    src = (_build.SRC_DIR / "spd_solve.cu").read_text()
    head, body = src.split("#include <cstdint>", 1)
    start = "  if (tid == 0) failed = 0;\n"
    assert start in body and "namespace {\n" in body
    body = body.replace("namespace {\n", "__device__ long long g_prof["
                        f"{_SLOTS}];\n__device__ int g_np;\nnamespace {{\n",
                        1)
    body = body.replace(start, start + "  if (blockIdx.x == 0 && tid == 0) "
                        "g_np = 0;\n  " + _STAMP + "\n")
    body = body.replace("__syncthreads();", "__syncthreads(); " + _STAMP)
    body += ('\nextern "C" int spd_solve_phases(long long* h, int* n) {\n'
             '  cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n'
             '  return (int)cudaMemcpyFromSymbol(n, g_np, sizeof(int));\n}\n')
    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "spd_solve_phases.cu", out / "libspd_solve_phases.so"
    cu.write_text(head + "#include <cstdint>" + body)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-o", str(so), str(cu)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("spd_solve_f32", "spd_solve_f64"):
        getattr(lib, name).argtypes = [P, P, P, P, I, I, I, P]
    return lib


def labels(T: int, R: int, G: int):
    """The phase ended by each barrier, in order (the kernel's loops)."""
    Tp = -(-T // 32) * 32
    nb = Tp // 32
    out = ["load", "load"]   # the copy, then the symmetrisation
    for p in range(nb):
        out += ["diagonal factor", "diagonal inverse"]
        if p < nb - 1:
            out += ["panel solve", "trailing update"]
    for _ in range(0, R, 32 * G):
        out += ["rhs load"] + ["substitution"] * (4 * nb) + ["store"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="+",
                    default=["16,90,90", "16,90,1", "16,32,1"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_b_phases.py needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build()
    ref = _build.load()
    rng = np.random.default_rng(0)
    for shape in args.shapes:
        n, T, R = map(int, shape.split(","))
        for dt in (torch.float32, torch.float64):
            f32 = dt == torch.float32
            if (ref.spd_solve_work_f32 if f32 else ref.spd_solve_work_f64)(
                    T, R):
                print(f"[phases] ({n},{T},{R}) {dt}: not in shared memory, "
                      "skipped", flush=True)
                continue
            M = rng.standard_normal((n, T, T))
            spd = torch.as_tensor((M @ M.transpose(0, 2, 1) + 5 * np.eye(T))
                                  * 37.0, dtype=dt, device="cuda")
            rhs = torch.as_tensor(rng.standard_normal((n, T, R)), dtype=dt,
                                  device="cuda")
            out = torch.empty_like(rhs)
            fn = lib.spd_solve_f32 if f32 else lib.spd_solve_f64
            for _ in range(3):
                _build.check(fn(spd.data_ptr(), rhs.data_ptr(),
                                out.data_ptr(), None, n, T, R,
                                torch.cuda.current_stream().cuda_stream),
                             "spd_solve (instrumented)")
            torch.cuda.synchronize()
            h, k = (ctypes.c_longlong * _SLOTS)(), ctypes.c_int()
            lib.spd_solve_phases(h, ctypes.byref(k))
            st = [h[i] for i in range(k.value)]
            # the G the launcher chose: the chunk count is what the
            # stamps show
            lab = next(lb for G in (4, 3, 2, 1)
                       if len(lb := labels(T, R, G)) == len(st) - 1)
            sums = OrderedDict()
            for name, a, b in zip(lab, st, st[1:]):
                sums[name] = sums.get(name, 0) + (b - a)
            total = st[-1] - st[0]
            parts = ", ".join(f"{k} {v} ({100 * v / total:.1f}%)"
                              for k, v in sums.items())
            print(f"[phases] ({n},{T},{R}) {dt}: {total} cycles of block 0; "
                  f"{parts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
