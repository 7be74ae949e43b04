"""tools/torch_trace_spans.py's readers of the stream engine's graphed
beat: the share of beats replayed from CUDA graphs and the host time a
beat in the graphed beat's spans. Each gives None on an empty record
and on a record without the graphed beat's counters or spans, and the
expected value on a small one. These tests go with the tool when the
harness reads the recorder itself."""

import runpy
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def tool():
    return runpy.run_path(str(ROOT / "tools" / "torch_trace_spans.py"))


def _span(i, name, a, b, parent=None):
    return dict(name=name, id=i, parent=parent, start_ns=a, end_ns=b,
                self_ns=b - a)


# two beats, one eager (beat 1) and one graphed (beat 2) with its
# copy-in, two replayed segments and its copy-out; three graph beats and
# one eager beat counted over the window
CTX = dict(program=dict(
    spans=[_span(1, "stream.step", 0, 10_000_000),
           _span(2, "stream.step", 0, 30_000_000),
           _span(3, "step.copy_in", 0, 100_000, 2),
           _span(4, "step.seg[1]", 0, 1_000_000, 2),
           _span(5, "step.seg[5]", 0, 600_000, 2),
           _span(6, "step.copy_out", 0, 50_000, 2)],
    counters={"stream.graph_beats": 3, "stream.eager_beats": 1}))
# the same beats as a program without the graphed beat records them
EAGER = dict(program=dict(
    spans=[_span(1, "stream.step", 0, 10_000_000),
           _span(2, "stream.step", 0, 30_000_000)],
    counters={"birth.trials": 8}))
EXPECT = {"stream.graph_beat_pct": 75.0,
          "stream.copy_in_ms": 0.05,
          "stream.replay_ms": 0.8,
          "stream.copy_out_ms": 0.025}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_tool_graph_readers(tool, name):
    read = tool["READ"][name]
    assert read({}) is None
    assert read(EAGER) is None
    assert read(CTX) == pytest.approx(EXPECT[name])
