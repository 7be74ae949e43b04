"""The recorder's spans and counters inside the refit and the kernel fit
(hdpgpc_torch.utils.metrics), hdpgpc_torch against itself on the CPU:

* build_refit at T = 24, J = 2 jobs, with an estimation limit below the
  member count (the hybrid refit's frozen tail) and without one: the
  recorder on and off give bit-identical RefitResults; float64 spans
  ``refit.tail_filter`` and ``refit.tail_smooth``, float32 with 128 or
  more tail slots ``refit.tail_steady`` (under 128 float32 runs every
  slot in the sequential scan); ``refit.head_slots`` and
  ``refit.tail_slots`` are J x the slots of the head and the tail, from
  the shapes;
* a batched kernel fit capped at 40 steps, below the plateau stop,
  counts 40 ``kernel_fit.steps`` and B ``kernel_fit.lanes`` inside one
  ``kernel_fit.adam[B]`` span, and fits the same on and off."""

import numpy as np
import pytest
import torch

from hdpgpc_torch.models import gplds
from hdpgpc_torch.models.kernel_fit import fit_kernel_batch
from hdpgpc_torch.ops.kernels import KernelParams
from hdpgpc_torch.utils import metrics

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T, J, N = 24, 2, 160
TAIL = {"refit.tail_filter", "refit.tail_smooth", "refit.tail_steady"}


def _recorded(fn):
    """``fn()`` with the recorder on; its result and snapshot."""
    metrics.reset()
    metrics.enable()
    try:
        out = fn()
    finally:
        metrics.disable()
    snap = metrics.snapshot()
    metrics.reset()
    return out, snap


def _refit_inputs(dtype):
    rng = np.random.default_rng(3)
    Y = (np.sin(np.linspace(0, 2 * np.pi, T))[None, None]
         + 0.1 * rng.standard_normal((J, N, T)))
    resp = np.ones((J, N))
    resp[1, ::7] = 0.0          # job 1 skips every seventh beat
    th = KernelParams(1.5, 2.0, 0.05)
    st = gplds.init_cluster_state(torch.arange(T, dtype=dtype), th, 0.02,
                                  0.1, 5.0, dtype=dtype)
    return (torch.as_tensor(Y, dtype=dtype),
            torch.as_tensor(resp, dtype=dtype),
            gplds.stack_states([st] * J))


# (dtype, estimation limit, slots of the head, the tail's spans): a
# float32 tail of 152 slots takes the steady-gain scan; one of 20 is
# no tail, float32 scans every slot sequentially
CASES = [("float64", 8, 8, {"refit.tail_filter", "refit.tail_smooth"}),
         ("float64", 140, 140, {"refit.tail_filter", "refit.tail_smooth"}),
         ("float32", 8, 8, {"refit.tail_steady"}),
         ("float32", 140, N, set()),
         ("float64", None, N, set())]


@pytest.mark.parametrize("dtype,est,head,tail", CASES)
def test_refit_spans_and_slot_counters(dtype, est, head, tail):
    dt = getattr(torch, dtype)
    refit = gplds.build_refit(T, est_limit=est, free_deg=5.0)
    inputs = _refit_inputs(dt)
    off = refit(*inputs)
    assert metrics.snapshot() == {"spans": [], "counters": {}}
    on, snap = _recorded(lambda: refit(*inputs))
    for a, b in zip(gplds.tree_leaves(on), gplds.tree_leaves(off),
                    strict=True):
        assert torch.equal(a, b)
    names = [s["name"] for s in snap["spans"]]
    assert set(names) & TAIL == tail
    for n in tail:
        assert names.count(n) == 1
    c = snap["counters"]
    assert c["refit.head_slots"] == J * head
    assert c.get("refit.tail_slots", 0) == J * (N - head)


def test_kernel_fit_steps_and_lanes():
    rng = np.random.default_rng(5)
    Ys = np.sin(np.linspace(0, 2 * np.pi, T))[None] \
        + 0.1 * rng.standard_normal((3, T))

    def fit():
        return fit_kernel_batch(np.arange(T, dtype=np.float64), Ys,
                                (0.001, 0.1), max_iters=40, device="cpu")

    off = fit()
    on, snap = _recorded(fit)
    assert snap["counters"] == {"kernel_fit.steps": 40,
                                "kernel_fit.lanes": 3}
    assert [s["name"] for s in snap["spans"]] == ["kernel_fit.adam[3]"]
    for a, b in zip(on, off, strict=True):
        for u, v in zip(a, b, strict=True):
            assert torch.equal(u, v)
