"""The benchmark harness: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything is found by name from BENCHMARK.json: the cell's
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``, whose ``driver`` names ``drivers/<driver>.py``)
and each metric's reader (``metrics/<metric>.py``). A driver builds the
program's objects from the configuration and the seed (``setup``),
drives the measured window (``window``) and hands what the window
produced to the cell's reference comparison (``check``).

The last line of standard output is the run's JSON result; the numbers
compared and their limits are the last lines of standard error too.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = HERE / "out"
FORBIDDEN = ("jax", "jaxlib", "flax", "hdpgpc_tpu")


def process_age() -> float:
    """Seconds since this process started (from /proc; the interpreter's
    own start-up included)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = float(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


_T_IMPORT = time.monotonic()


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic mix and
    metrics, read from ``root`` (the checkout's root)."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.cell = cells[name]
        confs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = confs[self.cell["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(root / "portbench" / "traffic"
                                 / f"{self.cell['traffic']}.json")
        self.chips = int(self.cell["chips"])

    def reports(self, m: Dict) -> bool:
        """Whether this cell reports metric ``m``: the cells its
        ``workloads`` lists, or every cell without the key."""
        return self.name in m.get("workloads", [self.name])

    def metric_defs(self, trace: bool):
        return [m for m in self.bench["per_layer" if trace else "end_to_end"]
                if self.reports(m)]

    def driver(self) -> ModuleType:
        d = self.traffic["driver"]
        return load_module(self.root / "portbench" / "drivers" / f"{d}.py",
                           f"portbench_driver_{d}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "portbench" / "metrics"
                           / f"{metric}.py",
                           "portbench_metric_" + metric.replace(".", "_"))


class Run:
    """What one run knows: the cell, its arguments, the device, and what
    the window and the trace recorded (``ctx``, read by the metric
    readers)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.ctx: Dict = {}
        self.out_dir = OUT / cell.name
        self.out_dir.mkdir(parents=True, exist_ok=True)


def _fmt(v: float) -> str:
    return repr(float(v))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, control: bool = False) -> Dict:
    """Set up, measure, check and read the metrics of one run; returns
    the result (without printing it; ``_forbidden`` names the modules of
    JAX or of the JAX package loaded by the end of the window). With
    ``control`` (the control's test only) the reference in the precision
    below the configuration's stands in the program's place."""
    import torch

    run = Run(cell, seed, seconds, trace, device)
    drv = cell.driver()
    state = drv.setup(run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.ctx["setup_s"] = process_age()
    drv.window(run, state)
    if device.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(device))
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN))
    t_check = time.perf_counter()
    drv.release(run, state)
    numbers = drv.check(run, state, control)
    run.ctx["check_s"] = time.perf_counter() - t_check
    limits = cell.config["limits"]
    checks = {k: {"value": float(numbers.get(k, math.inf)),
                  "limit": float(limits[k])} for k in limits}
    metrics = {}
    for m in cell.metric_defs(trace):
        v = cell.reader(m["name"]).read(run.ctx)
        if v is None:
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = run.ctx.get("busy_s", 0.0)
        dev["window_s"] = run.ctx.get("traced_s", 0.0)
    result = {"correct": bool(correct),
              "attempted": int(run.ctx.get("attempted", 0)),
              "failed": int(run.ctx.get("failed", 0)),
              "metrics": metrics, "device": dev}
    if trace and run.ctx.get("breakdown"):
        result["breakdown"] = run.ctx["breakdown"]
    result["checks"] = checks
    result["_forbidden"] = found
    for k in ("setup_s", "window_s", "check_s"):
        result["_" + k] = run.ctx.get(k, 0.0)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() \
            < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {n}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = result.pop("_forbidden")
    times = {k: result.pop(k) for k in ("_setup_s", "_window_s", "_check_s")}
    if found:
        print("portbench: modules of JAX or of the JAX package were loaded "
              f"in the measured process: {found}", file=sys.stderr)
        return 4
    print(f"portbench: set-up {times['_setup_s']:.2f} s, window "
          f"{times['_window_s']:.2f} s, check {times['_check_s']:.2f} s",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {_fmt(c['value'])} (limit {_fmt(c['limit'])})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
