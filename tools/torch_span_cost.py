"""Host cost of one span and one counter of the recorder in
``hdpgpc_torch.utils.metrics``, off and on, against an empty call, with
no profiler running. Prints one JSON line of microseconds a call, three
repeats each.

    python3 tools/torch_span_cost.py [--calls 200000]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hdpgpc_torch.utils import metrics  # noqa: E402


def per_call_us(fn, calls):
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t) / calls * 1e6


def bare():
    pass


def one_span():
    with metrics.span("x"):
        pass


def one_count():
    metrics.count("x")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=200000)
    calls = ap.parse_args(argv).calls
    out = {}
    for _ in range(3):
        metrics.disable()
        for key, fn in (("bare_us", bare), ("span_off_us", one_span),
                        ("count_off_us", one_count)):
            out.setdefault(key, []).append(per_call_us(fn, calls))
        metrics.reset()
        metrics.enable()
        for key, fn in (("span_on_us", one_span),
                        ("count_on_us", one_count)):
            out.setdefault(key, []).append(per_call_us(fn, calls))
        metrics.disable()
        metrics.reset()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
