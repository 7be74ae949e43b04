"""The fixed-K stress run of the frozen-cluster classifier on one CUDA
card: BASELINE config 5 (docs/STRESS.md), the default branch of
examples/torch_run_stress_stream.py (which holds the run), with its
result written to ``chiprun_out/torch_stream_classify.json``.

    python3 tools/torch_stream_classify.py [--beats 1000000] [--k 64]
"""

from __future__ import annotations

import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    run = runpy.run_path(os.path.join(ROOT, "examples",
                                      "torch_run_stress_stream.py"))["main"]
    res = run(argv + ["--json", os.path.join(ROOT, "chiprun_out",
                                             "torch_stream_classify.json")])
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
