"""The span and counter recorder of hdpgpc_torch.utils.metrics, on the
timer tests' sweep (T = 24, N = 40, float64, on the CPU) and on the
stream engine at a few dozen beats, hdpgpc_torch against itself:

* off, the recorder keeps nothing, ``span`` returns the shared null
  context and ``count`` does nothing, and neither the recorder's clock,
  its profiler annotation nor a device synchronise is reached;
* on, the sweep gives one ``sweep`` span per SweepMetrics record, every
  phase span a parent and self times that add up, counters that agree
  with the spans, and the same partitions, ELBOs and timer keys as off;
* a loop that the refill ends gives that pass a ``sweep.refill`` and
  no ``sweep``;
* the engine gives one ``stream.step`` a beat and one ``stream.refresh``
  a chunk; under torch.profiler the spans are ``hdpgpc.*`` annotations."""

import contextlib
import dataclasses
import functools
import io
import json

import numpy as np
import pytest
import torch

from hdpgpc_torch.data.loader import (default_x_basis, synthetic_beats,
                                      synthetic_growth_stream)
from hdpgpc_torch.data.priors import compute_estimators_lds
from hdpgpc_torch.models.hdpgpc import HDPGPC
from hdpgpc_torch.models.stream_online import OnlineStreamEngine
from hdpgpc_torch.utils import metrics

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T, N = 24, 40
KEYS = {"refit_batch", "refit_one", "seed_score", "fb", "kernel_fit",
        "q_elbo", "hdp_update", "warp"}
PHASES = ("sweep.", "first.")
STEP = {"step.score", "step.candidates", "step.elbo", "step.decide",
        "step.commit", "step.reorder"}
Y, Z = synthetic_beats(N, T=T, n_clusters=3, noise=0.03, seed=0)
SY, _SZ = synthetic_growth_stream(40, T, 3, seed=7, start_beat=0,
                                  interval=10)
CHUNK = 8
# the refill ends the loop at its fourth call, three sweeps in (the
# sweep alone runs six)
REFILL_END = 4


def _model():
    std, std_dif, bs, bg = compute_estimators_lds(Y)
    m = HDPGPC(default_x_basis(T), n_outputs=1, ini_lengthscale=3.0,
               bound_lengthscale=(1.0, 20.0), ini_gamma=std_dif,
               ini_sigma=std, ini_outputscale=10.0, bound_sigma=bs,
               bound_gamma=bg, hmm_switch=True, max_models=100,
               bayesian_params=True, reestimate_initial_params=True,
               n_explore_steps=3, free_deg_MNIV=5, compute_dtype="float64",
               device="cpu")
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters=300))
    return m


def _engine():
    std = float(np.std(SY))
    sd = float(np.std(np.diff(SY, axis=0)))
    m = HDPGPC(default_x_basis(T), n_outputs=1, ini_lengthscale=3.0,
               bound_lengthscale=(1.0, 20.0), ini_gamma=sd, ini_sigma=std,
               ini_outputscale=4.0, bound_sigma=(std * 0.05, std * 0.2),
               bound_gamma=(sd * 0.05, sd * 0.2), verbose=False,
               hmm_switch=True, max_models=6, bayesian_params=True,
               estimation_limit=50, free_deg_MNIV=5,
               compute_dtype="float64", device="cpu")
    m.cfg = dataclasses.replace(m.cfg, gp=dataclasses.replace(
        m.cfg.gp, kernel_fit_iters=100))
    return OnlineStreamEngine(m, K=6, chunk=CHUNK)


def _recorded(fn, on, timers=False):
    """Run ``fn(timers)`` with the recorder on or off; the result and
    the recorder's snapshot."""
    metrics.reset()
    if on:
        metrics.enable()
    try:
        out = fn(timers)
    finally:
        metrics.disable()
    snap = metrics.snapshot()
    metrics.reset()
    return out, snap


def _sweep(timers, end_at=None):
    m = _model()
    m._timing_on = timers
    if end_at is not None:
        refill, calls = m._refill, []

        def ending(resp, respPair):
            calls.append(1)
            resp, respPair, end = refill(resp, respPair)
            return resp, respPair, end or len(calls) == end_at
        m._refill = ending
    x = np.tile(np.arange(T, dtype=np.float64), (N, 1))
    with contextlib.redirect_stdout(io.StringIO()):
        m.include_batch(x, Y, with_warp=False)
    return m


def _stream(_timers):
    eng = _engine()
    with contextlib.redirect_stdout(io.StringIO()):
        eng.run(SY)
    return eng


def _raise(*_a, **_k):
    raise AssertionError("reached while the recorder is off")


@pytest.fixture(scope="module")
def sweeps():
    """The sweep timed and untimed, the recorder on and off; the
    untimed one with the recorder off runs with the recorder's clock,
    its profiler annotation and the device synchronise made to raise."""
    mp = pytest.MonkeyPatch()
    try:
        for name in ("_clock", "record_function"):
            mp.setattr(metrics, name, _raise)
        mp.setattr(torch.cuda, "synchronize", _raise)
        plain = _recorded(_sweep, False)
        stream_plain = _recorded(_stream, False)
    finally:
        mp.undo()
    return dict(plain=plain, stream_plain=stream_plain,
                timed_off=_recorded(_sweep, False, True),
                timed_on=_recorded(_sweep, True, True),
                untimed_on=_recorded(_sweep, True, False),
                refill_end=_recorded(functools.partial(
                    _sweep, end_at=REFILL_END), True),
                stream_on=_recorded(_stream, True))


def test_recorder_off_keeps_nothing(sweeps):
    assert not metrics._ON
    assert metrics.span("sweep") is metrics._NULL
    assert metrics.span("refit", 4) is metrics._NULL
    metrics.count("birth.trials", 3)
    assert metrics.snapshot() == {"spans": [], "counters": {}}
    for key in ("plain", "timed_off", "stream_plain"):
        assert sweeps[key][1] == {"spans": [], "counters": {}}


@pytest.mark.parametrize("key", ["timed_on", "untimed_on", "refill_end"])
def test_sweep_spans_nest(sweeps, key):
    m, snap = sweeps[key]
    spans = snap["spans"]
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    records = len(m.metrics.records)
    assert names.count("sweep") == records >= 2
    # a loop that ends after a record refills no more; one that the
    # refill ends has that pass's refill and no sweep
    ended = key == "refill_end"
    if ended:
        assert records == REFILL_END - 1
    assert names.count("sweep.refill") == records + ended
    for s in spans:
        assert s["self_ns"] >= 0
        if s["name"] in ("sweep", "sweep.refill"):
            assert s["parent"] is None
            continue
        if s["name"] == "hdp_update" and s["parent"] is None:
            # the first pass's update at one cluster, before its sweep
            continue
        # every phase span sits inside a sweep
        assert s["parent"] in by_id
        top = s
        while top["parent"] is not None:
            top = by_id[top["parent"]]
        assert top["name"] == "sweep"
        if s["name"].startswith("sweep."):
            assert by_id[s["parent"]]["name"] == "sweep"
        if s["name"].startswith("first."):
            assert by_id[s["parent"]]["name"] == "sweep.first"
    # children plus self equal the parent's duration (within 1 us)
    inner = {}
    for s in spans:
        if s["parent"] is not None:
            inner[s["parent"]] = inner.get(s["parent"], 0) \
                + s["end_ns"] - s["start_ns"]
    for s in spans:
        dur = s["end_ns"] - s["start_ns"]
        assert abs(s["self_ns"] + inner.get(s["id"], 0) - dur) <= 1000
    # the phases and the timed methods, by their timer keys
    assert {"sweep.first", "sweep.elbo", "first.q_simple",
            "first.birth_rank", "first.birth_trial"} <= set(names)
    assert {"refit_batch", "fb", "kernel_fit", "q_elbo",
            "hdp_update"} <= set(names)
    for n in set(names) - KEYS - {"sweep"}:
        assert n.startswith(PHASES + ("refit[", "kernel_fit.adam[")), n


def test_sweep_counters(sweeps):
    _m, snap = sweeps["timed_on"]
    c = snap["counters"]
    names = [s["name"] for s in snap["spans"]]
    assert 0 <= c.get("birth.accepted", 0) <= c["birth.trials"]
    assert c["birth.trials"] == names.count("first.birth_trial")
    jobs = [int(n[len("refit["):-1]) for n in names
            if n.startswith("refit[")]
    assert jobs and sum(jobs) == c["refit.jobs"]
    assert all(1 <= j <= HDPGPC._MAX_BATCH for j in jobs)


def test_recorder_changes_no_result(sweeps):
    base = sweeps["plain"][0]
    for key in ("timed_off", "timed_on", "untimed_on"):
        m = sweeps[key][0]
        assert m.M == base.M
        for a, b in zip(m.resp_assigned, base.resp_assigned, strict=True):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(m.train_elbo, base.train_elbo)
    on, off = sweeps["timed_on"][0], sweeps["timed_off"][0]
    assert set(on.timings) == set(off.timings) and on.timings
    assert set(on.counts) == set(off.counts)
    # the timers off, the wrapper opens the span and nothing else
    untimed = sweeps["untimed_on"][0]
    assert untimed.timings == {} and untimed.counts == {}
    np.testing.assert_array_equal(sweeps["stream_on"][0].labels(),
                                  sweeps["stream_plain"][0].labels())


def test_engine_spans(sweeps):
    eng, snap = sweeps["stream_on"]
    spans = snap["spans"]
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    beats = SY.shape[0]
    assert names.count("stream.step") == beats
    assert names.count("stream.refresh") == -(-beats // CHUNK)
    assert names.count("stream.collect") == 1
    for n in STEP | {"step.fit_read"}:
        assert names.count(n) == beats
    assert names.count("step.kernel_fit") == eng.step.fits >= 1
    for s in spans:
        parent = by_id.get(s["parent"], {}).get("name")
        if s["name"] in STEP:
            assert parent == "stream.step"
        elif s["name"] in ("step.fit_read", "step.kernel_fit"):
            assert parent == "step.commit"
        elif s["name"].startswith("kernel_fit.adam["):
            assert parent == "step.kernel_fit"
        elif s["name"].startswith("refresh."):
            assert parent == "stream.refresh"
        else:
            assert s["parent"] is None


def test_spans_under_profiler(tmp_path):
    eng = _engine()
    with contextlib.redirect_stdout(io.StringIO()):
        eng.run(SY[:CHUNK])
    metrics.reset()
    metrics.enable()
    try:
        with metrics.trace(str(tmp_path)):
            with contextlib.redirect_stdout(io.StringIO()):
                eng.run(SY[CHUNK:2 * CHUNK])
    finally:
        metrics.disable()
    metrics.reset()
    with open(tmp_path / "trace.json") as f:
        ev = json.load(f)["traceEvents"]
    ann = [e["name"] for e in ev if e.get("cat") == "user_annotation"]
    assert ann.count("hdpgpc.stream.step") == CHUNK
    assert ann.count("hdpgpc.stream.refresh") == 1
    assert "hdpgpc.step.fit_read" in ann
