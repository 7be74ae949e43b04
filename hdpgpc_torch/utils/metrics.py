"""Structured per-sweep metrics, the span and counter recorder, and the
profiler hooks (counterpart of hdpgpc_tpu.utils.metrics).

* ``SweepMetrics`` / ``MetricsLog``: one record per offline sweep.
* The recorder: ``span(name)`` brackets a phase of the program and
  ``count(name, n)`` adds to a named counter. Both do nothing until
  ``enable()`` (one module-level test, no clock read, no allocation);
  once enabled, a span keeps its name, id, parent (the span open on the
  same thread) and start and end (``time.perf_counter_ns``), and enters
  ``torch.profiler.record_function("hdpgpc." + name)``, so that under a
  profiler each span is a ``user_annotation`` on the clock of the
  device's kernel records. A span never synchronises a card: its
  interval is the host's. ``snapshot()`` returns the closed spans, each
  with its self time (its duration less its children's), and the
  counters; ``reset()`` empties both, ``disable()`` stops recording.
  Everything stays in memory.
* ``debug_nans`` raises on the first op that makes a NaN; ``trace``
  records a ``torch.profiler`` trace to a file.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
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


# ---- the span and counter recorder ----

PREFIX = "hdpgpc."
_ON = False
_NULL = contextlib.nullcontext()
# the recorder's clock and its profiler annotation (module names, so that
# a test can check that neither is reached while the recorder is off)
_clock = time.perf_counter_ns
record_function = torch.profiler.record_function
_spans: List[list] = []          # [name, id, parent id, start, end] (ns)
_counters: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()       # the spans open on each thread


class _Span:
    __slots__ = ("_rec", "_rf", "_stack")

    def __init__(self, name: str):
        self._rec = [name, 0, None, 0, None]

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self._rec
        rec[1] = next(_ids)
        rec[2] = stack[-1][1] if stack else None
        self._rf = record_function(PREFIX + rec[0])
        self._rf.__enter__()
        self._stack = stack
        stack.append(rec)
        _spans.append(rec)
        rec[3] = _clock()
        return self

    def __exit__(self, *exc):
        self._rec[4] = _clock()
        self._stack.pop()
        self._rf.__exit__(*exc)
        return False


def span(name: str, n: Optional[int] = None):
    """Context manager bracketing one phase; ``n`` is appended to the
    name as ``name[n]`` (a size the phase ran at). Off: the shared null
    context."""
    if not _ON:
        return _NULL
    return _Span(name if n is None else f"{name}[{n}]")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (nothing while the recorder is
    off)."""
    if _ON:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def reset() -> None:
    """Forget every recorded span and counter."""
    _spans.clear()
    _counters.clear()


def snapshot() -> Dict:
    """``{"spans": [...], "counters": {...}}``: every closed span as a
    dict of ``name``, ``id``, ``parent`` (None at the top), ``start_ns``,
    ``end_ns`` and ``self_ns`` (the duration less the durations of its
    closed children), in the order the spans opened."""
    done = [r for r in _spans if r[4] is not None]
    inner: Dict[int, int] = {}
    for r in done:
        if r[2] is not None:
            inner[r[2]] = inner.get(r[2], 0) + r[4] - r[3]
    return dict(
        spans=[dict(name=r[0], id=r[1], parent=r[2], start_ns=r[3],
                    end_ns=r[4], self_ns=r[4] - r[3] - inner.get(r[1], 0))
               for r in done],
        counters=dict(_counters))


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
