"""The traced run's device view: a bounded slice of the window under
``torch.profiler`` (CPU and CUDA activity), read from its Chrome trace.

A slice gives the device's busy time (the union of kernel, copy and set
intervals), its wall time, the device time by kernel name, each
harness span's launched kernels (a span's kernels are those whose
launch, matched by CUPTI correlation id, lies inside the span on the
same host thread), and the idle gaps named by the innermost harness
span around them."""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "portbench."


class Slice:
    """Profile from ``start()`` until ``maybe_stop()`` finds ``duration``
    seconds gone (or ``stop()``); the device is synchronised at both
    ends."""

    def __init__(self, duration: float, device):
        self.duration = float(duration)
        self.device = device
        self.prof = None
        self.active = False
        self.done = False
        self.wall = 0.0
        self.units = 0          # work counted inside the slice (beats)
        self.overhead = 0.0     # host seconds spent starting and stopping

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        t = time.perf_counter()
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()
        self.overhead += self.t0 - t
        self.active = True

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def maybe_stop(self):
        if self.active and time.perf_counter() - self.t0 >= self.duration:
            self.stop()

    def stop(self):
        if not self.active:
            return
        self._sync()
        t = time.perf_counter()
        self.wall = t - self.t0
        self.prof.stop()
        self.overhead += time.perf_counter() - t
        self.active = False
        self.done = True

    def analyse(self, path: Path) -> Optional[Dict]:
        """Read the slice's Chrome trace (written to ``path`` and deleted
        after); None when the trace holds no device activity."""
        if not self.done:
            return None
        self.prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        return summarise(events, self.wall)


def _union(intervals: List[tuple]) -> float:
    tot, cur0, cur1 = 0.0, None, None
    for a, b in sorted(intervals):
        if cur1 is None or a > cur1:
            if cur1 is not None:
                tot += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        tot += cur1 - cur0
    return tot


def summarise(events: List[Dict], wall: float) -> Optional[Dict]:
    kernels, spans, launches = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            kernels.append((ts, ts + dur, e.get("name", "?"),
                            (e.get("args") or {}).get("correlation")))
        elif cat == "user_annotation" and e.get("name", "").startswith(
                PREFIX):
            spans.append((ts, ts + dur, e["name"][len(PREFIX):],
                          e.get("tid")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches.append((ts, e.get("tid"), corr))
    if not kernels:
        return None
    busy_us = _union([(a, b) for a, b, _n, _c in kernels])
    by_name = defaultdict(float)
    k_by_corr = defaultdict(float)
    for a, b, n, c in kernels:
        by_name[n] += (b - a) * 1e-6
        if c is not None:
            k_by_corr[c] += (b - a) * 1e-6
    # each span's launched device time: launches inside it, same thread
    spans.sort()
    launches.sort()
    span_dev = []
    lts = [l[0] for l in launches]
    for a, b, name, tid in spans:
        i0, i1 = bisect.bisect_left(lts, a), bisect.bisect_right(lts, b)
        dev = sum(k_by_corr.get(c, 0.0) for ts, t, c in launches[i0:i1]
                  if t == tid)
        span_dev.append((name, a, b, dev))
    # idle gaps between device intervals, named by the innermost span
    ivs = sorted((a, b) for a, b, _n, _c in kernels)
    gaps = defaultdict(float)
    starts = [s[0] for s in spans]
    cur = ivs[0][1]
    for a, b in ivs[1:]:
        if a > cur:
            mid = 0.5 * (a + cur)
            name = "host outside any span"
            j = bisect.bisect_right(starts, mid)
            best = None
            for s in spans[max(0, j - 64):j]:
                if s[0] <= mid <= s[1] and (best is None or s[0] >= best[0]):
                    best = s
            if best is not None:
                name = best[2].split("[")[0]
            gaps[name] += (a - cur) * 1e-6
        cur = max(cur, b)
    return dict(wall=wall, busy=busy_us * 1e-6, n_kernels=len(kernels),
                by_name=dict(by_name), spans=span_dev, gaps=dict(gaps))


def dump(summary: Dict, path: Path) -> None:
    """The slice's spans by name (count, host seconds, device seconds)
    and its device time by kernel name, for a reader of the run's
    output directory."""
    spans = defaultdict(lambda: [0, 0.0, 0.0])
    for name, a, b, dev in summary["spans"]:
        s = spans[name]
        s[0] += 1
        s[1] += (b - a) * 1e-6
        s[2] += dev
    with open(path, "w") as f:
        json.dump(dict(wall=summary["wall"], busy=summary["busy"],
                       n_kernels=summary["n_kernels"], spans=spans,
                       by_name=summary["by_name"], gaps=summary["gaps"]),
                  f, indent=1)


def breakdown(summary: Dict) -> Dict:
    """The ten device operations that took most time and the ten longest
    idle-gap totals, by what the host was doing."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n[:200], s] for n, s in gaps]}


def span(name: str):
    """A harness span (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(PREFIX + name)
