"""Evaluation: cluster-vs-label contingency and classification error.

Parity with the reference's ``print_results`` (util_plots.py:269-299):
majority label per cluster; error = sum of non-majority assignments
over the total number of beats.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def print_results(model, labels: Sequence, n0: int = 0, error: bool = False,
                  purity: bool = False, quiet: bool = False):
    """model: an HDPGPC instance (uses .member_indexes() and .T_count)."""
    member_idx = model.member_indexes()
    M = len(member_idx)
    main_model: List = ["None"] * M
    for i in range(M):
        labs, counts = np.unique([labels[j + n0] for j in member_idx[i]],
                                 return_counts=True)
        sr = "[" + ",".join(f"{l}-{c}" for l, c in zip(labs, counts)) + "]"
        mm = ""
        if len(counts) > 0:
            main_model[i] = labs[np.argmax(counts)]
            mm = ": MainModel: " + str(main_model[i])
        if not quiet:
            print("Model", i + 1, mm, ":", sr)
    err = np.zeros(M)
    for m in range(M):
        for i in member_idx[m]:
            if labels[i + n0] != main_model[m]:
                err[m] += 1
        if purity and len(member_idx[m]) > 0 and not quiet:
            print("Model", m + 1, ": Purity: ",
                  1 - err[m] / len(member_idx[m]))
    total = model.T_count
    if not quiet:
        print(f"Classification error: {int(err.sum())} / {total} -- "
              f"{int(err.sum()) / total:.5f}")
    if purity:
        return main_model, int(err.sum()), total - int(err.sum())
    if error:
        return main_model, int(err.sum())
    return main_model


def classification_error(model, labels: Sequence, n0: int = 0
                         ) -> Tuple[int, int]:
    """(errors, total) without printing."""
    _, err = print_results(model, labels, n0, error=True, quiet=True)
    return err, model.T_count


def adjusted_rand_index(a: Sequence, b: Sequence) -> float:
    """Adjusted Rand index between two hard partitions (label values
    arbitrary). Used to quantify partition agreement where exact
    member-set parity is not the contract (f32-vs-f64 speed-mode
    validation, warp-path divergence bounds)."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    n = a.shape[0]
    if n == 0:
        return 1.0
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    cont = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(cont, (ai, bi), 1)

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(cont).sum()
    sum_a = comb2(cont.sum(axis=1)).sum()
    sum_b = comb2(cont.sum(axis=0)).sum()
    total = comb2(np.asarray(n))
    expected = sum_a * sum_b / total if total > 0 else 0.0
    max_idx = 0.5 * (sum_a + sum_b)
    if max_idx == expected:
        return 1.0
    return float((sum_ij - expected) / (max_idx - expected))
