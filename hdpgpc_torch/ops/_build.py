"""Build and load the hand-written CUDA kernels.

Every ``*.cu`` file under ``hdpgpc_torch/csrc`` is compiled by ``nvcc``
into one shared library with a plain C interface, at first use, into
``hdpgpc_torch/_build/`` under a name keyed by a hash of the sources
(so an edited source is rebuilt, and an unchanged one is reused). The
library is loaded with ``ctypes``; no PyTorch headers are compiled, so
a build takes seconds.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a card, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
# filled by load(): library path, seconds spent in nvcc (0.0 when the
# library was already built), and nvcc's -Xptxas -v report
BUILD_INFO: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "spd_solve_max_t": [],
    "spd_solve_f32": [_P, _P, _P, _I, _I, _I, _P],
    "spd_solve_f64": [_P, _P, _P, _I, _I, _I, _P],
    "rbf_gram_f32": [_P, _P, _P, _P, _I, _I, _P],
    "rbf_gram_f64": [_P, _P, _P, _P, _I, _I, _P],
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


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhdpgpc_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the library (no-op when it exists)."""
    so = library_path()
    log = so.with_suffix(".log")
    if so.exists():
        BUILD_INFO.update(path=str(so), seconds=0.0,
                          ptxas=log.read_text() if log.exists() else "")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    BUILD_INFO.update(path=str(so), seconds=seconds,
                      ptxas=proc.stdout + proc.stderr)
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
