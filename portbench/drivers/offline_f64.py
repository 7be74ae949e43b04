"""Driver of the float64 offline sweep: the offline driver's set-up,
window and release (``drivers/offline.py``) on a configuration in
float64, with the program's recorder on in traced runs and the check
against the configuration's reference (``reference/offline_f64.py``).

A traced run's window resets and enables the recorder of
``hdpgpc_torch.utils.metrics`` first, puts its ``snapshot()`` in
``ctx["recorder"]`` at the end and disables it in a ``finally``; the
readers of the refit's slot counters and the kernel fit's step counter
take it from there. Untraced runs leave the recorder off.
"""

from __future__ import annotations

from portbench.drivers import offline
from portbench.reference import offline_f64 as ref

setup = offline.setup
release = offline.release


def window(run, st):
    if not run.trace:
        offline.window(run, st)
        return
    from hdpgpc_torch.utils import metrics
    metrics.reset()
    metrics.enable()
    try:
        offline.window(run, st)
        run.ctx["recorder"] = metrics.snapshot()
    finally:
        metrics.disable()
        metrics.reset()


def check(run, st, control=False):
    return ref.check(st["cap"], run.config, run.device, control)
