"""GP covariance (Gram) construction: Constant * RBF + White
(counterpart of hdpgpc_tpu.ops.kernels), with kernel A
(``csrc/rbf_gram.cu``).

The reference builds sklearn kernels ``ConstantKernel(c) * RBF(l) +
WhiteKernel(n)`` (GPI_HDP.py:159-166). sklearn semantics are kept:

* two-argument evaluation ``k(X, Y)`` does NOT add white noise, even
  when ``X is Y`` (GPI.py:136-139 relies on it);
* one-argument evaluation ``k(X)`` adds ``n`` on the diagonal.

``gram`` sends every 1-D grid through ``fused_rbf_gram``: the plain
version (``rbf_gram_noise``) for a CPU tensor, kernel A for a CUDA
tensor, in both dtypes and at any T, with the noise term fused into
the one launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hdpgpc_torch.ops import _build


class KernelParams(NamedTuple):
    """theta of Constant(c) * RBF(lengthscale) + White(noise)."""

    outputscale: torch.Tensor   # c   (constant_value)
    lengthscale: torch.Tensor   # l
    noise: torch.Tensor         # n   (noise_level, a variance)


def rbf_gram(x1: torch.Tensor, x2: torch.Tensor, outputscale,
             lengthscale) -> torch.Tensor:
    """Plain version: c * exp(-0.5 |x1 - x2|^2 / l^2); x1 (T1,) or
    (T1, D), x2 (T2,) or (T2, D)."""
    a = x1.reshape(x1.shape[0], -1)
    b = x2.reshape(x2.shape[0], -1)
    d2 = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)
    return outputscale * torch.exp(-0.5 * d2 / (lengthscale ** 2))


def rbf_gram_noise(x1: torch.Tensor, x2: torch.Tensor, outputscale,
                   lengthscale, noise=None) -> torch.Tensor:
    """Plain version of kernel A: ``rbf_gram``, plus ``noise`` on the
    diagonal when it is given (needs T1 == T2)."""
    K = rbf_gram(x1, x2, outputscale, lengthscale)
    if noise is not None:
        K = K + noise * torch.eye(K.shape[0], dtype=K.dtype,
                                  device=K.device)
    return K


def _device_scalar(v, dt: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``v`` as a one-element tensor of ``dt`` on ``dev``: the tensor
    itself when it already is one (KernelParams on the main path)."""
    if (isinstance(v, torch.Tensor) and v.dtype == dt and v.device == dev
            and v.numel() == 1):
        return v
    return torch.as_tensor(v, dtype=dt, device=dev).reshape(())


def fused_rbf_gram(x1: torch.Tensor, x2: torch.Tensor, outputscale,
                   lengthscale, noise=None) -> torch.Tensor:
    """RBF Gram of 1-D grids x1 (T1,), x2 (T2,) -> (T1, T2), plus
    ``noise`` on the diagonal when it is given: the plain version on the
    CPU, kernel A (one launch) on a CUDA tensor."""
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return rbf_gram_noise(x1, x2, outputscale, lengthscale, noise)
    if not (x1.is_cuda and x2.is_cuda and x1.device == x2.device):
        raise ValueError(f"fused_rbf_gram: inputs on {x1.device} and "
                         f"{x2.device}; both must be on one CUDA device")
    if x1.dtype != x2.dtype or x1.dtype not in (torch.float32,
                                                torch.float64):
        raise TypeError(f"fused_rbf_gram: dtypes {x1.dtype}, {x2.dtype}")
    if x1.ndim != 1 or x2.ndim != 1:
        raise ValueError("fused_rbf_gram: the kernel takes 1-D grids")
    if not (x1.is_contiguous() and x2.is_contiguous()):
        raise ValueError("fused_rbf_gram: inputs must be contiguous")
    T1, T2 = x1.shape[0], x2.shape[0]
    if noise is not None and T1 != T2:
        raise ValueError(f"fused_rbf_gram: noise on the diagonal of a "
                         f"({T1}, {T2}) Gram")
    dt, dev = x1.dtype, x1.device
    out = torch.empty((T1, T2), dtype=dt, device=dev)
    if T1 == 0 or T2 == 0:
        return out
    c = _device_scalar(outputscale, dt, dev)
    ls = _device_scalar(lengthscale, dt, dev)
    n = None if noise is None else _device_scalar(noise, dt, dev)
    lib = _build.load()
    fn = lib.rbf_gram_f32 if dt == torch.float32 else lib.rbf_gram_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(x1.data_ptr(), x2.data_ptr(), c.data_ptr(),
                        ls.data_ptr(), None if n is None else n.data_ptr(),
                        out.data_ptr(), T1, T2, stream), "rbf_gram")
    fused_rbf_gram.launches += 1
    return out


fused_rbf_gram.launches = 0


def gram(params: KernelParams, x1: torch.Tensor,
         x2: Optional[torch.Tensor] = None,
         include_noise: Optional[bool] = None) -> torch.Tensor:
    """Evaluate the kernel; ``include_noise=None`` follows sklearn:
    noise added iff called one-argument (x2 is None)."""
    if x2 is None:
        x2 = x1
        if include_noise is None:
            include_noise = True
    elif include_noise is None:
        include_noise = False
    if x1.numel() != x1.shape[0] or x2.numel() != x2.shape[0]:
        raise NotImplementedError("gram: only 1-D input grids are ported")
    return fused_rbf_gram(x1.reshape(-1).contiguous(),
                          x2.reshape(-1).contiguous(),
                          params.outputscale, params.lengthscale,
                          params.noise if include_noise else None)
