"""Build and load the hand-written CUDA kernels.

Each ``*.cu`` file under ``hdpgpc_torch/csrc`` is compiled by its own
``nvcc`` process, all started together, into a shared library with a
plain C interface, at first use, into ``hdpgpc_torch/_build/`` under a
name keyed by a hash of that source and the flags (so an edited source
is rebuilt, and an unchanged one is reused). The libraries are loaded
with ``ctypes``; no PyTorch headers are compiled, so a build takes
seconds.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a card, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[types.SimpleNamespace] = None
# one build at a time: threads driving several cards share the libraries
_LOCK = threading.Lock()
# filled by build(): library paths, wall seconds spent in nvcc (0.0 when
# every library was already built), and nvcc's -Xptxas -v reports
BUILD_INFO: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# per source: exported function -> (argument types, return type)
_SIGNATURES = {
    "spd_solve": {
        "spd_solve_work_f32": ([_I, _I], _L),
        "spd_solve_work_f64": ([_I, _I], _L),
        "spd_solve_f32": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
        "spd_solve_f64": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    },
    "rbf_gram": {
        "rbf_gram_f32": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
        "rbf_gram_f64": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    },
}


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.name.encode())
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every source whose library is missing, one nvcc process
    per source, in parallel; returns {source stem: library path}."""
    libs = {p.stem: library_path(p) for p in sources()}
    todo = [(p, libs[p.stem]) for p in sources() if not libs[p.stem].exists()]
    t0 = time.perf_counter()
    procs = []
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        for src, so in todo:
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((so, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    failures = []
    for so, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))
    logs = [so.with_suffix(".log") for so in libs.values()]
    BUILD_INFO.update(
        paths=[str(p) for p in libs.values()],
        seconds=time.perf_counter() - t0 if todo else 0.0,
        ptxas="".join(p.read_text() for p in logs if p.exists()))
    return libs


def load() -> types.SimpleNamespace:
    """The kernels' C functions, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _load_all()
    return _LIB


def _load_all() -> types.SimpleNamespace:
    fns = {}
    for stem, so in build().items():
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in _SIGNATURES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
            fns[name] = fn
    return types.SimpleNamespace(**fns)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
