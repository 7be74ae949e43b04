"""Times and bounds of the port's kernels on the card, for
``chip_smoke.py`` and ``tools/torch_profile_sweep.py``.

* ``events_ms``: eager launches between two CUDA events. Where the host
  takes longer to issue a launch than the card takes to run it, this
  is the host's time per call, not the kernel's.
* ``device_ms``: the card's time per call, which the host cannot hide:
  ``reps`` calls captured once in a CUDA graph and the graph replayed
  between two CUDA events (capture takes the kernels' ctypes launches,
  which go to PyTorch's current stream). The time includes the graph's
  own gap between launches: kernel A, nanoseconds of stores, reads
  about 2 us this way on an H100.
* ``*_bound``: the least time the card could take for a call: the
  larger of the bytes it must move (each input read once, each output
  written once) over the memory rate, and its operations over the peak
  rate, with which of the two sets it.

Peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet): 3.35 TB/s
of device memory; 67 TFLOP/s in float32 outside the tensor cores and
67 TFLOP/s in float64 (its tensor cores).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 67e12}


def events_ms(fn: Callable[[], object], reps: int = 200,
              warm: int = 10) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn: Callable[[], object], reps: int = 200) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _bound(nbytes: float, ops: float, dtype) -> Tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def spd_solve_bound(n: int, T: int, R: int, dtype) -> Tuple[float, str]:
    """Kernel B: spd (n, T, T) and rhs (n, T, R) read, X (n, T, R)
    written; T^3/3 for the factor and 2 T^2 R for the two
    substitutions, per system."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = n * (T * T + 2 * T * R) * size
    ops = n * (T ** 3 / 3.0 + 2.0 * T * T * R)
    return _bound(nbytes, ops, dtype)


def rbf_gram_bound(T1: int, T2: int, dtype, D: int = 1
                   ) -> Tuple[float, str]:
    """Kernel A with the noise on (T, D) grids: the grids and the 3
    parameters read, the (T1, T2) Gram written; 3 D + 3 operations an
    element (a difference, a square and an add a dimension, less one
    add; scale, divide, exp, times c), plus one add per diagonal
    element."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = ((T1 + T2) * D + 3 + T1 * T2) * size
    ops = (3.0 * D + 3.0) * T1 * T2 + min(T1, T2)
    return _bound(nbytes, ops, dtype)
