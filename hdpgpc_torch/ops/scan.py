"""Parallel prefix scan over the leading axis.

torch has no public counterpart of ``jax.lax.associative_scan``. This
one follows the same recursive even/odd reduction (Blelloch 1990, as
written in jax/_src/lax/control_flow/loops.py), so the combines happen
in the same order and float64 results round like the JAX reference's.
"""

from __future__ import annotations

from typing import Callable

import torch


def _interleave(even, odd):
    n = even.shape[0] + odd.shape[0]
    out = even.new_empty((n,) + tuple(even.shape[1:]))
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(fn: Callable, elems, reverse: bool = False):
    """Inclusive scan of the associative ``fn(earlier, later)``.

    ``elems``: one tensor or a tuple/list of tensors sharing the leading
    length; ``fn`` takes and returns the same structure. With
    ``reverse=True`` the scan runs from the end (suffix combines), as in
    JAX: the elements are flipped, scanned, and flipped back.
    """
    single = not isinstance(elems, (tuple, list))
    flat = [elems] if single else list(elems)
    if reverse:
        flat = [e.flip(0) for e in flat]

    def combine(a, b):
        out = fn(a[0] if single else tuple(a), b[0] if single else tuple(b))
        return [out] if single else list(out)

    def _scan(xs):
        n = xs[0].shape[0]
        if n < 2:
            return xs
        # the reduced level is not bound here, so it is freed as soon as
        # the recursion returns (the classifier's scan holds (K, B, T, T)
        # elements)
        odd = _scan(combine([x[0:n - 1:2] for x in xs],
                            [x[1::2] for x in xs]))
        if n % 2 == 0:
            even = combine([o[:-1] for o in odd], [x[2::2] for x in xs])
        else:
            even = combine(odd, [x[2::2] for x in xs])
        even = [torch.cat([x[:1], e]) for x, e in zip(xs, even)]
        return [_interleave(e, o) for e, o in zip(even, odd)]

    out = _scan(flat)
    if reverse:
        out = [o.flip(0) for o in out]
    return out[0] if single else tuple(out)
