"""Each plain reference agrees with the port on the CPU in float64 at a
tiny size, through the harness's own run (which also gives the result
line's keys)."""

import math

from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _agree(r, exact):
    assert [k for k in r if not k.startswith("_")] == KEYS
    assert r["_forbidden"] == []
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    for name, c in r["checks"].items():
        assert math.isfinite(c["value"])
        assert c["value"] <= exact.get(name, 1e-9), (name, c)


def test_offline_reference_agrees():
    r = tiny.run(tiny.offline())
    assert set(r["metrics"]) == {"record_s", "setup_s"}
    _agree(r, {"fb_rows": 0.0})


def test_stream_reference_agrees():
    r = tiny.run(tiny.stream())
    assert set(r["metrics"]) == {"beats_per_s", "setup_s"}
    _agree(r, {"decisions": 0.0, "labels": 0.5})
