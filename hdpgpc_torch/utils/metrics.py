"""Structured per-sweep metrics and the profiler hooks (counterpart of
hdpgpc_tpu.utils.metrics): ``debug_nans`` raises on the first op that
makes a NaN, ``trace`` records a ``torch.profiler`` trace, ``Timer``
keeps wall-clock laps (synchronising a card first when given one)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclass
class SweepMetrics:
    """Per-sweep record: ELBO pieces, cluster counts, wall time."""

    iteration: int = 0
    elbo: float = float("nan")
    q_obs: float = float("nan")
    elbo_linear: float = float("nan")
    n_clusters: int = 0
    resp_counts: List[int] = field(default_factory=list)
    seconds: float = 0.0

    def to_dict(self) -> Dict:
        return dict(iteration=self.iteration, elbo=self.elbo,
                    q_obs=self.q_obs, elbo_linear=self.elbo_linear,
                    n_clusters=self.n_clusters,
                    resp_counts=self.resp_counts, seconds=self.seconds)


class MetricsLog:
    def __init__(self):
        self.records: List[Dict] = []

    def append(self, **kw):
        kw.setdefault("t_wall", time.time())
        self.records.append(kw)

    def dump(self, path: str):
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")


class _RaiseOnNaN(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"{func} produced a NaN")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise FloatingPointError on the first op whose output holds a NaN
    (replaces the reference's isnan print sentinels, GPI_HDP.py:625-626,
    :3605). Every op output is read back, so a card waits on each op:
    for debugging only."""
    if not enable:
        yield
        return
    with _RaiseOnNaN():
        yield


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace (host and, on a card, device activity) around
    a block, written to ``log_dir/trace.json`` (chrome://tracing,
    Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Wall-clock laps; with ``device`` a CUDA device, each clock read
    waits for the card's queued work first."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = None if device is None else torch.device(device)
        self.t0 = self._now()
        self.laps: Dict[str, float] = {}

    def _now(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str):
        now = self._now()
        self.laps[name] = self.laps.get(name, 0.0) + now - self.t0
        self.t0 = now
        return self.laps[name]
