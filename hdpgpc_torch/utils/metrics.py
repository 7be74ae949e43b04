"""Structured per-sweep metrics (counterpart of hdpgpc_tpu.utils.metrics;
the profiler hooks are not ported yet, see ROADMAP A15)."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List


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
