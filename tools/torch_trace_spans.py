"""One run of a benchmark cell with the port's span and counter recorder
on, and what its spans say.

    python3 tools/torch_trace_spans.py --workload offline.f32 --seed 7 \\
        --seconds 30 --trace 1

Runs ``portbench``'s cell as ``portbench/run.py`` does (same set-up,
window, comparison and metrics), with two additions:

* the recorder of ``hdpgpc_torch.utils.metrics`` is turned on at the
  start of the window (after ``reset()``), its ``snapshot()`` taken
  into the run's record at the end and the recorder turned off;
* the profiled slice of a ``--trace 1`` run is read by ``summarise``
  below: the harness's own summary, unchanged, plus the program's spans
  (``hdpgpc.*`` annotations) with the device time and the kernels
  launched inside each, and every idle gap named by the innermost span
  of either kind (a program span keeps its ``hdpgpc.`` prefix).

From these it reads the per-layer quantities of the recorder (``read``)
and, offline, how much of the window the ``sweep`` spans cover and how
far the orchestration's self time plus the timed phases account for a
sweep. Prints the harness's result with them as one JSON line.
A run without the recorder is ``portbench/run.py``'s.

Until the harness reads the recorder itself, this tool stands in for
it: ``program_spans``, ``name_gaps`` and ``READ`` belong in
``portbench``, and the tool and its tests
(``portbench/tests/test_portbench_trace_spans.py`` and
``portbench/tests/test_portbench_trace_spans_graph.py``) go when they
are there.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

PROGRAM = "hdpgpc."
HARNESS = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "host outside any span"
REFIT = re.compile(r"refit\[(\d+)\]")
ORCHESTRATION = ("sweep.", "first.")


# ---- the slice: the harness's summary plus the program's spans ----

def program_spans(events: List[Dict]) -> List[tuple]:
    """Each ``hdpgpc.*`` annotation as (name without the prefix, start,
    end (us), device seconds and kernels launched inside it on its
    thread, matched by correlation id)."""
    kernels, launches, spans = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            if corr is not None:
                k = kernels.setdefault(corr, [0.0, 0])
                k[0] += dur * 1e-6
                k[1] += 1
        elif cat in ("cuda_runtime", "cuda_driver"):
            if corr is not None:
                launches.append((ts, e.get("tid"), corr))
        elif cat == "user_annotation" and e.get("name", "").startswith(
                PROGRAM):
            spans.append((ts, ts + dur, e["name"][len(PROGRAM):],
                          e.get("tid")))
    launches.sort()
    lts = [t for t, _tid, _c in launches]
    out = []
    for a, b, name, tid in sorted(spans):
        dev, n = 0.0, 0
        for _t, t_tid, c in launches[bisect.bisect_left(lts, a):
                                     bisect.bisect_right(lts, b)]:
            if t_tid == tid and c in kernels:
                dev += kernels[c][0]
                n += kernels[c][1]
        out.append((name, a, b, dev, n))
    return out


def name_gaps(events: List[Dict]) -> Dict[str, float]:
    """Idle gaps between device intervals (seconds), each named by the
    innermost annotation of either kind open at its midpoint: a harness
    span by its name, a program span by ``hdpgpc.<name>``, a size in
    brackets dropped."""
    ivs, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ivs.append((ts, ts + dur))
        elif cat == "user_annotation":
            if name.startswith(HARNESS):
                spans.append((ts, -(ts + dur), name[len(HARNESS):]))
            elif name.startswith(PROGRAM):
                spans.append((ts, -(ts + dur), name))
    if not ivs:
        return {}
    ivs.sort()
    spans.sort()         # by start, the outer of two equal starts first
    gaps = defaultdict(float)
    stack: List[tuple] = []
    j = 0
    cur = ivs[0][1]
    for a, b in ivs[1:]:
        if a > cur:
            mid = 0.5 * (a + cur)
            while j < len(spans) and spans[j][0] <= mid:
                s = spans[j]
                while stack and -stack[-1][1] < s[0]:
                    stack.pop()
                stack.append(s)
                j += 1
            while stack and -stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2].split("[")[0] if stack else OUTSIDE
            gaps[name] += (a - cur) * 1e-6
        cur = max(cur, b)
    return dict(gaps)


def summarise(events: List[Dict], wall: float,
              harness_summarise=None) -> Optional[Dict]:
    """``portbench.trace.summarise`` (``busy``, ``by_name``,
    ``n_kernels`` and ``spans`` as it gives them), with its ``gaps``
    named by the innermost span of either kind and the program's spans
    under ``program_spans``."""
    if harness_summarise is None:
        from portbench.trace import summarise as harness_summarise
    s = harness_summarise(events, wall)
    if s is None:
        return None
    s["gaps"] = name_gaps(events)
    s["program_spans"] = program_spans(events)
    return s


# ---- the recorder's per-layer quantities ----

def _spans(ctx, name):
    p = ctx.get("program")
    if not p:
        return []
    return [s for s in p["spans"] if s["name"] == name]


def _dur_s(s):
    return (s["end_ns"] - s["start_ns"]) * 1e-9


def orchestration_s(ctx) -> Optional[float]:
    """Self time of ``sweep``, ``sweep.*`` and ``first.*`` a sweep:
    include_batch's own host code."""
    p = ctx.get("program")
    if not p or not ctx.get("sweeps"):
        return None
    own = [s["self_ns"] for s in p["spans"]
           if s["name"] == "sweep" or s["name"].startswith(ORCHESTRATION)]
    if not own:
        return None
    return sum(own) * 1e-9 / ctx["sweeps"]


def refit_kernels_per_job(ctx) -> Optional[float]:
    """Device kernels launched inside the slice's ``refit[J]`` spans
    over the sum of their J."""
    s = ctx.get("slice")
    if not s or not s.get("program_spans"):
        return None
    jobs = kernels = 0
    for name, _a, _b, _dev, n in s["program_spans"]:
        m = REFIT.fullmatch(name)
        if m:
            jobs += int(m.group(1))
            kernels += n
    return kernels / jobs if jobs else None


def _counter(ctx, name):
    p = ctx.get("program")
    return None if not p else p["counters"].get(name, 0)


def birth_trials(ctx) -> Optional[float]:
    n = _counter(ctx, "birth.trials")
    return None if n is None or not ctx.get("sweeps") \
        else n / ctx["sweeps"]


def birth_accept_pct(ctx) -> Optional[float]:
    n = _counter(ctx, "birth.trials")
    return None if not n else 100.0 * _counter(ctx, "birth.accepted") / n


def beat_ms(ctx, q) -> Optional[float]:
    d = [_dur_s(s) * 1e3 for s in _spans(ctx, "stream.step")]
    return float(np.percentile(d, q)) if d else None


def fit_read_ms(ctx) -> Optional[float]:
    beats = len(_spans(ctx, "stream.step"))
    if not beats:
        return None
    return sum(_dur_s(s) for s in _spans(ctx, "step.fit_read")) * 1e3 \
        / beats


def refresh_host_ms(ctx) -> Optional[float]:
    r = _spans(ctx, "stream.refresh")
    return sum(_dur_s(s) for s in r) * 1e3 / len(r) if r else None


def graph_beat_pct(ctx) -> Optional[float]:
    """Beats replayed from the step's CUDA graphs over all beats."""
    g = _counter(ctx, "stream.graph_beats")
    n = None if g is None else g + _counter(ctx, "stream.eager_beats")
    return 100.0 * g / n if n else None


def step_ms(ctx, prefix) -> Optional[float]:
    """Host time a beat in the graphed beat's spans named ``prefix``
    (``step.seg`` takes every ``step.seg[i]``)."""
    p = ctx.get("program")
    beats = len(_spans(ctx, "stream.step"))
    if not p or not beats:
        return None
    d = [_dur_s(s) for s in p["spans"]
         if s["name"] == prefix or s["name"].startswith(prefix + "[")]
    return sum(d) * 1e3 / beats if d else None


READ = {
    "offline.orchestration_s": orchestration_s,
    "offline.refit_kernels_per_job": refit_kernels_per_job,
    "offline.birth_trials": birth_trials,
    "offline.birth_accept_pct": birth_accept_pct,
    "stream.beat_p50_ms": lambda c: beat_ms(c, 50),
    "stream.beat_p95_ms": lambda c: beat_ms(c, 95),
    "stream.fit_read_ms": fit_read_ms,
    "stream.refresh_host_ms": refresh_host_ms,
    "stream.graph_beat_pct": graph_beat_pct,
    "stream.copy_in_ms": lambda c: step_ms(c, "step.copy_in"),
    "stream.replay_ms": lambda c: step_ms(c, "step.seg"),
    "stream.copy_out_ms": lambda c: step_ms(c, "step.copy_out"),
}


def read(ctx) -> Dict[str, float]:
    out = {}
    for k, f in READ.items():
        v = f(ctx)
        if v is not None and math.isfinite(v):
            out[k] = v
    return out


def coverage(ctx) -> Dict[str, float]:
    """Offline: the share of the window inside ``sweep`` spans, and the
    orchestration's self time plus every timed phase (the synchronising
    timers, when on) over the window's seconds, both a sweep."""
    out = {}
    sweeps, win = ctx.get("sweeps"), ctx.get("window_s")
    if not sweeps or not win:
        return out
    sw = _spans(ctx, "sweep")
    if sw:
        out["sweep_cover"] = sum(_dur_s(s) for s in sw) / win
    orch = orchestration_s(ctx)
    t = ctx.get("timings")
    if orch is not None and t:
        out["orchestration_plus_timed_over_sweep"] = \
            (orch + sum(t.values()) / sweeps) / (win / sweeps)
    return out


def idle_split(ctx) -> Dict[str, float]:
    """The slice's idle-gap seconds by name, and the share outside any
    span."""
    s = ctx.get("slice")
    if not s or not s.get("gaps"):
        return {}
    tot = sum(s["gaps"].values())
    return dict(total_s=tot, outside_share=(s["gaps"].get(OUTSIDE, 0.0)
                                            / tot if tot else 0.0))


# ---- the run ----

def run(cell, seed: int, seconds: float, trace: bool, device):
    """``portbench.bench.run_cell`` with the recorder on over the window
    and the slice read by ``summarise``; returns the
    harness's result with the recorder's readings under ``recorder``,
    and the run's record."""
    from hdpgpc_torch.utils import metrics
    from portbench import bench
    from portbench import trace as tr

    runs = []

    class Run(bench.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    driver = cell.driver

    def with_recorder():
        mod = driver()
        window = mod.window

        def recorded(run, st):
            metrics.reset()
            metrics.enable()
            try:
                window(run, st)
            finally:
                run.ctx["program"] = metrics.snapshot()
                metrics.disable()
                metrics.reset()
        mod.window = recorded
        return mod

    harness, harness_run = tr.summarise, bench.Run
    bench.Run = Run
    tr.summarise = lambda ev, wall: summarise(ev, wall, harness)
    cell.driver = with_recorder
    try:
        res = bench.run_cell(cell, seed, seconds, trace, device)
    finally:
        bench.Run, tr.summarise = harness_run, harness
        del cell.driver
    ctx = runs[-1].ctx
    res.pop("_forbidden", None)
    prog = ctx.get("program") or {}
    self_s = defaultdict(float)
    for sp in prog.get("spans", []):
        self_s[REFIT.sub("refit", sp["name"])] += sp["self_ns"] * 1e-9
    res["recorder"] = dict(metrics=read(ctx), coverage=coverage(ctx),
                           idle=idle_split(ctx),
                           counters=prog.get("counters", {}),
                           n_spans=len(prog.get("spans", [])),
                           self_s=dict(self_s),
                           timings=ctx.get("timings"),
                           **{k: ctx.get(k) for k in (
                               "window_s", "sweeps", "beats",
                               "trace_overhead_s")})
    s = ctx.get("slice")
    if s and s.get("program_spans"):
        by = defaultdict(lambda: [0, 0.0, 0.0, 0])
        for name, a, b, dev, n in s["program_spans"]:
            k = by[REFIT.sub("refit", name)]
            k[0] += 1
            k[1] += (b - a) * 1e-6
            k[2] += dev
            k[3] += n
        res["recorder"]["slice_program_spans"] = dict(by)
    return res, ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import portbench.run  # noqa: F401  (the harness's environment)
    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("torch_trace_spans: needs a CUDA device", file=sys.stderr)
        return 3
    res, _ctx = run(bench.Cell(args.workload), args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0))
    res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
