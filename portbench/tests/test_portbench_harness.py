"""The harness: BENCHMARK.json keeps to the contract's form, cells,
mixes and metrics are found by name, nothing it loads is JAX or the JAX
package, and without a card it prints no result."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
FORBIDDEN = {"jax", "jaxlib", "flax", "hdpgpc_tpu"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_form():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    confs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(confs) == len(b["configs"]) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert (ROOT / c["file"]).is_file()
    assert len({c["file"] for c in b["configs"]}) == len(confs)
    cells = b["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in confs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    assert {w["config"] for w in cells} == set(confs)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(b["per_layer"]) <= 128
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in {w["name"] for w in cells}
                   for c in m.get("workloads", []))
        assert (ROOT / "portbench" / "metrics"
                / f"{m['name']}.py").is_file()
    for w in cells:
        cell = bench.Cell(w["name"], ROOT)
        rep = {m["name"] for m in cell.metric_defs(False)}
        assert "setup_s" in rep and len(rep) >= 2
        assert cell.metric_defs(True)
        for m in cell.metric_defs(True):
            assert m["moves"] in rep


def test_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric added as files, with
    their entries, are found without an edit to an existing file."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / b["configs"][0]["file"]).read_text())
    conf["compute_dtype"] = "float64"
    (tmp_path / "portbench/configs/new_conf.json").write_text(
        json.dumps(conf))
    traffic = json.loads((ROOT / "portbench/traffic" /
                          f"{b['workloads'][0]['traffic']}.json").read_text())
    traffic["n_beats"] = 1000
    (tmp_path / "portbench/traffic/new_mix.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/metrics/new.metric.py").write_text(
        "def read(ctx):\n    return ctx.get('sweeps')\n")
    b["configs"].append(dict(b["configs"][0], name="new_conf",
                             file="portbench/configs/new_conf.json"))
    b["workloads"].append(dict(name="new.cell", config="new_conf",
                               traffic="new_mix", chips=1, why="x"))
    b["per_layer"].append(dict(name="new.metric", unit="sweeps",
                               better="higher", source="program_counter",
                               layer="x", moves="record_s",
                               workloads=["new.cell"]))
    b["end_to_end"][0]["workloads"].append("new.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.Cell("new.cell", tmp_path)
    assert cell.config["compute_dtype"] == "float64"
    assert cell.traffic["n_beats"] == 1000
    assert cell.driver().__name__.startswith("portbench_driver_")
    per_layer = [m["name"] for m in cell.metric_defs(True)]
    assert per_layer == ["new.metric"]
    assert cell.reader("new.metric").read({"sweeps": 3}) == 3


def _top_modules(code):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys; print(' '.join(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=ROOT, capture_output=True,
        text=True, check=True)
    return set(out.stdout.split())


def test_no_jax_in_the_harness():
    """Top-level names compared whole: hdpgpc_torch shares a prefix with
    hdpgpc_tpu."""
    mods = _top_modules(
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import bench, trace\n"
        "from portbench.drivers import offline, stream\n"
        "from portbench.reference import gplds, hdp, hmm, kernel_fit, "
        "offline as r1, stream as r2\n"
        "from portbench.metrics import common\n"
        "import hdpgpc_torch.models.hdpgpc, "
        "hdpgpc_torch.models.stream_online")
    assert "hdpgpc_torch" in mods and not mods & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    mods = _top_modules(
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench.reference import gplds, hdp, hmm, kernel_fit, "
        "offline, stream")
    assert not mods & (FORBIDDEN | {"hdpgpc_torch"})


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "offline.f32", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
