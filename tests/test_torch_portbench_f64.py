"""The benchmark's float64 offline cell (offline.f64) on the CPU at a
tiny size: 160 beats of the cell's record at T = 90, estimation limit 30
(so every refit job has a frozen tail), one traced run through
``portbench.bench.run_cell`` with the program's kernel fits at their
float64 budget of 4000 steps.

* every compared number is finite and within the configuration's
  limits, ``hdp`` and ``fb_rows`` exactly 0, and the recorder is off
  again after the traced window;
* the traced run reports each of the cell's readers of the program's
  timers and counters;
* each of the cell's nine readers gives its value on a synthetic
  record, None on an empty one, and the counter readers None on a
  record of a program without the counters."""

import math

import pytest
import torch

from portbench import bench
from portbench.frozen.roofline import spd_solve_bound
from hdpgpc_torch.utils import metrics

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

SEED = 2 ** 31 + 1717
CELL = "offline.f64"
# from the program's timers and counters (the device-trace readers
# need a card)
PROGRAM = ("f64.refit_s", "f64.kernel_fit_s", "f64.kernel_fit_steps",
           "f64.refit_slots", "kernel_b.launches.f64")
COUNTERS = {"kernel_fit.steps": 4400, "kernel_fit.lanes": 12,
            "refit.head_slots": 16000, "refit.tail_slots": 10000}
CTX = dict(
    sweeps=4, timings={"refit_batch": 6.0, "refit_one": 2.0,
                       "kernel_fit": 1.0},
    kfit_prefetch_s=0.8, spd_launches=8000, peak_bytes=5 * 2 ** 30,
    recorder=dict(spans=[], counters=COUNTERS),
    slice=dict(wall=1.0, busy=0.1,
               by_name={"potrf_kernel": 0.03, "spd_solve_kernel": 0.05,
                        "elementwise_kernel": 0.02},
               spans=[("spd_solve[16,90,90,float64]", 0, 1, 1e-3),
                      ("spd_solve[16,90,90,float32]", 0, 1, 5e-4),
                      ("refit", 0, 1, 0.0)]))
EXPECT = {"f64.refit_s": (8.0 - 0.8) / 4,
          "f64.kernel_fit_s": (1.0 + 0.8) / 4,
          "f64.kernel_fit_steps": 4400 / 4,
          "f64.refit_slots": 26000 / 4,
          "kernel_b.launches.f64": 2000.0,
          "kernel_b.roofline_pct.f64":
              100.0 * spd_solve_bound(16, 90, 90, "float64")[0],
          "linalg.device_pct.f64": 30.0,
          "device.idle_pct.f64": 90.0,
          "device.peak_gib.f64": 5.0}


@pytest.fixture(scope="module")
def cell():
    return bench.Cell(CELL)


@pytest.fixture(scope="module")
def result():
    c = bench.Cell(CELL)
    c.traffic = dict(c.traffic, n_beats=160, warmup_beats=40)
    c.config = dict(c.config, estimation_limit=30)
    return bench.run_cell(c, SEED, 1.0, True, torch.device("cpu"))


def test_checks_within_the_limits(result, cell):
    assert not metrics._ON
    checks = result["checks"]
    assert set(checks) == set(cell.config["limits"])
    for name, c in checks.items():
        assert math.isfinite(c["value"]), name
        assert c["value"] <= c["limit"], (name, c)
    assert checks["hdp"]["value"] == 0.0
    assert checks["fb_rows"]["value"] == 0.0
    assert result["correct"]
    assert result["attempted"] >= 2 and result["failed"] == 0


@pytest.mark.parametrize("name", PROGRAM)
def test_traced_run_reports(result, name):
    assert result["metrics"][name]["value"] >= 0.0
    if name in ("f64.kernel_fit_steps", "f64.refit_slots"):
        assert result["metrics"][name]["value"] > 0.0


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(cell, name):
    read = cell.reader(name).read
    assert read({}) is None
    assert read(CTX) == pytest.approx(EXPECT[name])
    if name in ("f64.kernel_fit_steps", "f64.refit_slots"):
        assert read(dict(CTX, recorder=dict(spans=[], counters={}))) is None
