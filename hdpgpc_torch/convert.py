"""numpy -> port converters for the reference's state containers.

They take the JAX package's ``KernelParams``, ``MNIW`` and
``ClusterState`` with numpy leaves (``jax.device_get`` of the JAX
objects; any NamedTuple with the same field names works) and build the
port's, so that a test can feed both packages one state. This module
imports no JAX. ``stream_state_from_numpy`` does the same for the
stream engine's carry, and ``online_caches_from_numpy`` copies a model's
online caches and HDP globals (numpy in both packages), so that both
packages can go on from one mid-stream state.
``frozen_stream_state_from_numpy`` builds the frozen-cluster
classifier's state (models/streaming.py), and
``record_states_from_numpy`` the (R, K)-batched states of the
multi-record step (parallel/records.py). ``tree_leaves`` and
``tree_unflatten`` flatten a state in ``jax.tree.leaves`` order
(NamedTuple fields depth-first), the order of the checkpoints' per-leaf
keys, which both packages write and read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hdpgpc_torch.models.gplds import ClusterState, tree_leaves  # noqa: F401
from hdpgpc_torch.models.mniw import MNIW
from hdpgpc_torch.models import streaming
from hdpgpc_torch.models.stream_online import StreamState
from hdpgpc_torch.ops.kernels import KernelParams
from hdpgpc_torch.ops.stick_breaking import HDPGlobals


def _t(x, device, dtype):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def kernel_params_from_numpy(d, device="cpu", dtype=torch.float64
                             ) -> KernelParams:
    return KernelParams(*[_t(getattr(d, f), device, dtype)
                          for f in KernelParams._fields])


def mniw_from_numpy(d, device="cpu", dtype=torch.float64) -> MNIW:
    """``n0`` is kept in float64 in both compute dtypes (models/mniw.py)."""
    return MNIW(mean=_t(d.mean, device, dtype),
                row_cov=_t(d.row_cov, device, dtype),
                n0=_t(d.n0, device, torch.float64),
                scale=_t(d.scale, device, dtype))


def cluster_state_from_numpy(d, device="cpu", dtype=torch.float64
                             ) -> ClusterState:
    fields = {}
    for f in ClusterState._fields:
        v = getattr(d, f)
        if f == "theta":
            fields[f] = kernel_params_from_numpy(v, device, dtype)
        elif f in ("mniw_int", "mniw_obs"):
            fields[f] = mniw_from_numpy(v, device, dtype)
        elif f == "n":
            fields[f] = _t(v, device, torch.int32)
        else:
            fields[f] = _t(v, device, dtype)
    return ClusterState(**fields)


def record_states_from_numpy(d, device="cpu", dtype=torch.float64
                             ) -> ClusterState:
    """hdpgpc_tpu's (R, K)-batched ``ClusterState`` (its
    parallel.records.init_record_states or a step's output, numpy
    leaves) as the port's, every leaf with its (R, K) leading dims."""
    st = cluster_state_from_numpy(d, device, dtype)
    if st.n.ndim != 2 or st.K0.shape[:2] != st.n.shape:
        raise ValueError(f"record states need (R, K) leading dims; the "
                         f"counts have shape {tuple(st.n.shape)}")
    return st


_STREAM_INT = ("n", "last_t", "prev_state", "M_rho", "M", "t", "slot_uid",
               "uid_next")


def stream_state_from_numpy(d, device="cpu", dtype=torch.float64
                            ) -> StreamState:
    """The engine's carry: the (K, ...) cluster bank in ``dtype``, the
    accounting in float64, counters and ids in int32, ``fitted`` bool."""
    fields = {}
    for f in StreamState._fields:
        v = getattr(d, f)
        if f == "states":
            fields[f] = cluster_state_from_numpy(v, device, dtype)
        elif f == "fitted":
            fields[f] = _t(v, device, torch.bool)
        elif f in _STREAM_INT:
            fields[f] = _t(v, device, torch.int32)
        else:
            fields[f] = _t(v, device, torch.float64)
    return StreamState(**fields)


ONLINE_CACHES = ("q_last", "q_lat_last", "resp_last", "respPair_last",
                 "T_count", "glob")


def online_caches_from_numpy(d) -> dict:
    """Copies of a model's online caches (``q_last``, ``q_lat_last``,
    ``resp_last``, ``respPair_last``), its beat count and its HDP
    globals, keyed by attribute name, to set on a port model."""
    out = {f: np.array(getattr(d, f), np.float64)
           for f in ONLINE_CACHES[:4]}
    out["T_count"] = int(d.T_count)
    out["glob"] = HDPGlobals(**{f.name: getattr(d.glob, f.name)
                                for f in dataclasses.fields(HDPGlobals)})
    return out


def frozen_stream_state_from_numpy(d, device="cpu", dtype=torch.float64
                                   ) -> streaming.StreamState:
    """The frozen-cluster classifier's state, every field in ``dtype``
    (hdpgpc_tpu's ``counts`` may come as float64 in a float32 state:
    it is compared by value)."""
    return streaming.StreamState(*[_t(getattr(d, f), device, dtype)
                                   for f in streaming.StreamState._fields])


def tree_unflatten(proto, leaves, device="cpu"):
    """A tree shaped like ``proto`` from ``leaves`` (numpy or tensors,
    in ``tree_leaves`` order), each leaf on ``device`` in the dtype of
    the prototype's leaf."""
    it = iter(leaves)

    def build(p):
        if isinstance(p, tuple):
            return type(p)(*[build(x) for x in p])
        return torch.as_tensor(np.asarray(next(it)), dtype=p.dtype,
                               device=device)

    out = build(proto)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the prototype")
    return out
