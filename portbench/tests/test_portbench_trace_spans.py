"""tools/torch_trace_spans.py, the stand-in for the harness's reading of
the port's span and counter recorder: its summary of a slice keeps the
harness's fields, it names idle gaps by the innermost span of either
kind, and its readers give None on an empty record and the expected
value on a small one. These tests go with the tool when the harness
reads the recorder itself."""

import runpy
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def tool():
    return runpy.run_path(str(ROOT / "tools" / "torch_trace_spans.py"))


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# device: kernels at [0, 10], [30, 40], [100, 110], [200, 210] us, each
# launched at the start of its interval less 5 us; a harness span
# around all, a program sweep inside it, a refit[2] and a step.commit
# with a step.fit_read inside
DEVICE = [_ev("kernel", "k%d" % i, a, 10.0, tid=7, corr=i)
          for i, a in enumerate((0.0, 30.0, 100.0, 200.0))]
LAUNCH = [_ev("cuda_runtime", "cudaLaunchKernel", a - 5.0, 1.0, corr=i)
          for i, a in enumerate((0.0, 30.0, 100.0, 200.0))]
HARNESS = [_ev("user_annotation", "portbench.stream.step", -10.0, 300.0)]
PROGRAM = [_ev("user_annotation", "hdpgpc.sweep", -8.0, 290.0),
           _ev("user_annotation", "hdpgpc.refit[2]", 20.0, 30.0),
           _ev("user_annotation", "hdpgpc.step.commit", 90.0, 100.0),
           _ev("user_annotation", "hdpgpc.step.fit_read", 150.0, 20.0)]


def test_tool_summary_keeps_the_harness_fields(tool):
    from portbench.trace import summarise
    plain = summarise(DEVICE + LAUNCH + HARNESS, 0.3)
    both = tool["summarise"](DEVICE + LAUNCH + HARNESS + PROGRAM, 0.3)
    for k in ("wall", "busy", "by_name", "n_kernels", "spans"):
        assert both[k] == plain[k]
    ps = {p[0]: p for p in both["program_spans"]}
    assert set(ps) == {"sweep", "refit[2]", "step.commit",
                       "step.fit_read"}
    assert ps["refit[2]"][3:] == pytest.approx((10e-6, 1))
    assert ps["sweep"][3:] == pytest.approx((40e-6, 4))
    assert ps["step.fit_read"][4] == 0


def test_tool_names_gaps_by_the_innermost_span(tool):
    g = tool["name_gaps"](DEVICE + LAUNCH + HARNESS + PROGRAM)
    # gaps [10, 30] (mid 20: refit[2] opens at 20), [40, 100] (mid 70:
    # the sweep), [110, 200] (mid 155: step.fit_read)
    assert g == pytest.approx({"hdpgpc.refit": 20e-6,
                               "hdpgpc.sweep": 60e-6,
                               "hdpgpc.step.fit_read": 90e-6})
    g = tool["name_gaps"](DEVICE + HARNESS)
    assert g == pytest.approx({"stream.step": 170e-6})
    # a gap inside a long span after 145 short ones inside it is
    # still the long span's
    many = [_ev("user_annotation", "portbench.spd_solve[4,90,90,float32]",
                41.1 + 0.2 * i, 0.05) for i in range(150)]
    g = tool["name_gaps"](DEVICE + HARNESS + many)
    assert g == pytest.approx({"stream.step": 170e-6})
    g = tool["name_gaps"](DEVICE)
    assert g == pytest.approx({"host outside any span": 170e-6})


def _span(i, name, a, b, parent=None, self_ns=None):
    return dict(name=name, id=i, parent=parent, start_ns=a, end_ns=b,
                self_ns=b - a if self_ns is None else self_ns)


CTX = dict(
    sweeps=2, window_s=1.0,
    program=dict(
        spans=[_span(1, "sweep", 0, 600_000_000, self_ns=100_000_000),
               _span(2, "sweep.first", 0, 300_000_000, 1, 50_000_000),
               _span(3, "refit_batch", 0, 250_000_000, 2),
               _span(4, "stream.step", 0, 10_000_000),
               _span(5, "step.fit_read", 0, 2_000_000, 4),
               _span(6, "stream.step", 0, 30_000_000),
               _span(7, "stream.refresh", 0, 16_000_000)],
        counters={"birth.trials": 8, "birth.accepted": 2}),
    slice=dict(program_spans=[("refit[2]", 0, 1, 0.0, 50),
                              ("refit[4]", 0, 1, 0.0, 100),
                              ("sweep", 0, 1, 0.0, 999)]))
EXPECT = {"offline.orchestration_s": 0.075,
          "offline.refit_kernels_per_job": 25.0,
          "offline.birth_trials": 4.0,
          "offline.birth_accept_pct": 25.0,
          "stream.beat_p50_ms": 20.0,
          "stream.beat_p95_ms": 29.0,
          "stream.fit_read_ms": 1.0,
          "stream.refresh_host_ms": 16.0}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_tool_readers(tool, name):
    read = tool["READ"][name]
    assert read({}) is None
    assert read(CTX) == pytest.approx(EXPECT[name])
