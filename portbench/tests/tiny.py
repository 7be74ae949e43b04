"""Tiny versions of the cells for the CPU tests: the harness's look for
a card skipped, the rest of a run driven on the CPU."""

import torch

from portbench import bench

SEED = 2 ** 31 + 77


def offline(dtype="float64"):
    c = bench.Cell("offline.f32")
    c.traffic = dict(c.traffic, n_beats=60, warmup_beats=40)
    c.config = dict(c.config, compute_dtype=dtype)
    return c


def stream(dtype="float64"):
    c = bench.Cell("online.steady")
    c.traffic = dict(c.traffic, check_window_beats=32, check_steps=4,
                     window_beats=480)
    c.config = dict(c.config, compute_dtype=dtype)
    return c


def run(cell, seconds=2.0):
    return bench.run_cell(cell, SEED, seconds, False, torch.device("cpu"))
