"""The port's drivers on the CPU at a few dozen synthetic beats (there
is no MIT-BIH data here, so each falls back to synthetic data and says
so): examples/torch_run_{offline,online,reload_classify,ocean,
all_records}.py, tools/torch_validate_f32.py and
tools/torch_profile_offline.py, float32 with the kernel fits capped;
examples/torch_run_stress_stream.py --grow on a growth stream.
The all-records driver's concurrent mode gives each record the
sequential mode's (M, error)."""

import contextlib
import io
import json
import os
import runpy

import numpy as np
import pytest
import torch

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = ["--device", "cpu", "--fit-iters", "60"]


@pytest.fixture(autouse=True)
def no_data(monkeypatch):
    monkeypatch.setenv("HDPGPC_DATA_DIR", "")
    monkeypatch.delenv("HDPGPC_TIMING", raising=False)


def _run(path, argv):
    main = runpy.run_path(os.path.join(ROOT, path))["main"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue()


def test_offline_driver(tmp_path):
    pytest.importorskip("matplotlib")
    png = str(tmp_path / "clusters.png")
    m, out = _run("examples/torch_run_offline.py",
                  ["--beats", "24", "--dtype", "float32", "--out", png]
                  + QUICK)
    assert "synthetic_beats(24" in out and "Classification error" in out
    assert m.M >= 2 and str(m.device) == "cpu" and os.path.exists(png)


def test_online_driver():
    m, out = _run("examples/torch_run_online.py", ["--beats", "12"] + QUICK)
    assert "streaming synthetic_beats(12" in out
    assert m.T_count == 12 and "Classification error" in out


def test_reload_classify_driver():
    acc, out = _run("examples/torch_run_reload_classify.py",
                    ["--train", "24", "--test", "8"] + QUICK)
    assert "2 leads" in out and "Classified 8 new beats" in out
    assert acc >= 0.75


def test_ocean_driver():
    m, out = _run("examples/torch_run_ocean.py",
                  ["--n", "12", "--regimes", "2", "--dtype", "float64"]
                  + QUICK)
    assert "synthetic spectra on a 171-point axis" in out
    assert m.Tb == 171 and m.M >= 1 and "OCEAN" in out


def test_all_records_driver_modes_agree():
    argv = ["--synthetic", "2", "--beats", "16", "--dtype", "float32"] \
        + QUICK
    seq, out = _run("examples/torch_run_all_records.py", argv)
    conc, out2 = _run("examples/torch_run_all_records.py",
                      argv + ["--devices", "2"])
    assert "2 synthetic records" in out and "concurrent mode" in out2
    assert [r[:5] for r in seq] == [r[:5] for r in conc]
    assert [r[0] for r in seq] == ["synthetic0", "synthetic1"]


def test_validate_f32_tool(tmp_path):
    argv = ["--synthetic", "1", "--beats", "16", "--out-dir",
            str(tmp_path)] + QUICK
    combined, out = _run("tools/torch_validate_f32.py", argv)
    assert "1 synthetic records" in out
    (key, r), = combined.items()
    assert key == "synthetic0@16" and 0.0 <= r["ari"] <= 1.0 + 1e-12
    assert r["f64"]["tot"] == 16 and r["f32"]["M"] >= 1
    with open(tmp_path / "f32_validation.json") as f:
        assert json.load(f)[key]["ari"] == r["ari"]
    assert "| synthetic0 (synthetic) | 16 |" in (
        tmp_path / "f32_validation.md").read_text()
    # resumable: a second run of an arm re-runs nothing
    _, again = _run("tools/torch_validate_f32.py", argv + ["--arm", "f64"])
    assert "synthetic0@16: done" in again


def test_profile_offline_tool(monkeypatch):
    monkeypatch.setenv("HDPGPC_TIMING", "0")
    m, out = _run("tools/torch_profile_offline.py",
                  ["16", "--device", "cpu"])
    assert "[time] total tracked" in out and "s/sweep" in out
    assert set(m.timings) and np.isfinite(sum(m.timings.values()))


def test_stress_stream_driver_grow(tmp_path):
    """examples/torch_run_stress_stream.py --grow: the engine's chunk is
    the example's min(--chunk, 1024), the progress and result lines go to
    --log, the result to --json."""
    log, res_path = tmp_path / "grow.jsonl", tmp_path / "grow.json"
    res, out = _run("examples/torch_run_stress_stream.py",
                    ["--grow", "--beats", "48", "--k", "3", "--t", "24",
                     "--chunk", "4096", "--log", str(log), "--json",
                     str(res_path)] + QUICK)
    assert out.splitlines()[0] == "cpu"
    assert "GROWTH STRESS DONE: 48 beats, K_slots=3" in out
    assert res["mode"] == "grow" and res["ok"] and res["chunk"] == 1024
    assert res["beats"] == 48 and 1 <= res["clusters_born"] <= 3
    assert res["kernel_fits"] >= 1 and res["peak_device_bytes"] is None
    assert 0.0 < res["accuracy"] <= 1.0
    lines = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert lines[0]["beats"] == 48 and lines[-1]["event"] == "done"
    with open(res_path) as f:
        assert json.load(f)["clusters_born"] == res["clusters_born"]
