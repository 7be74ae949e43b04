"""numpy -> port converters for the reference's state containers.

They take the JAX package's ``KernelParams``, ``MNIW`` and
``ClusterState`` with numpy leaves (``jax.device_get`` of the JAX
objects; any NamedTuple with the same field names works) and build the
port's, so that a test can feed both packages one state. This module
imports no JAX. ``HDPGlobals`` (ops/stick_breaking.py) is numpy in both
packages and needs no conversion.
"""

from __future__ import annotations

import numpy as np
import torch

from hdpgpc_torch.models.gplds import ClusterState
from hdpgpc_torch.models.mniw import MNIW
from hdpgpc_torch.ops.kernels import KernelParams


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
