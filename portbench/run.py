"""Run one cell of the benchmark once; see portbench/bench.py.

    python3 portbench/run.py --workload offline.f32 --seed 7 \\
        --seconds 30 --trace 0
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / "out" / "cache"
# every build and kernel cache at a fixed place inside the checkout (the
# program's CUDA kernels build into hdpgpc_torch/_build/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
# one process with few threads: the host work is small, and idle
# library threads spinning beside the launching thread make runs spread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from portbench.bench import main
    sys.exit(main())
