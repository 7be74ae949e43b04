"""GP covariance (Gram) construction: Constant * RBF + White
(counterpart of hdpgpc_tpu.ops.kernels), with kernel A
(``csrc/rbf_gram.cu``).

The reference builds sklearn kernels ``ConstantKernel(c) * RBF(l) +
WhiteKernel(n)`` (GPI_HDP.py:159-166). sklearn semantics are kept:

* two-argument evaluation ``k(X, Y)`` does NOT add white noise, even
  when ``X is Y`` (GPI.py:136-139 relies on it);
* one-argument evaluation ``k(X)`` adds ``n`` on the diagonal.

``gram`` sends every 1-D grid through ``fused_rbf_gram``: the plain
version for a CPU tensor, kernel A for a CUDA tensor, in both dtypes
and at any T. The noise term stays outside the kernel.
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


def fused_rbf_gram(x1: torch.Tensor, x2: torch.Tensor, outputscale,
                   lengthscale) -> torch.Tensor:
    """RBF Gram of 1-D grids x1 (T1,), x2 (T2,) -> (T1, T2): the plain
    version on the CPU, kernel A on a CUDA tensor."""
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return rbf_gram(x1, x2, outputscale, lengthscale)
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
    dt = x1.dtype
    # (c, l) as a device pair in the grid's dtype: no host round trip
    cl = torch.stack([torch.as_tensor(v, device=x1.device).to(dt)
                      for v in (outputscale, lengthscale)])
    T1, T2 = x1.shape[0], x2.shape[0]
    out = torch.empty((T1, T2), dtype=dt, device=x1.device)
    if T1 == 0 or T2 == 0:
        return out
    lib = _build.load()
    fn = lib.rbf_gram_f32 if dt == torch.float32 else lib.rbf_gram_f64
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        _build.check(fn(x1.data_ptr(), x2.data_ptr(), cl.data_ptr(),
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
    K = fused_rbf_gram(x1.reshape(-1).contiguous(),
                       x2.reshape(-1).contiguous(),
                       params.outputscale, params.lengthscale)
    if include_noise:
        K = K + params.noise * torch.eye(K.shape[0], dtype=K.dtype,
                                         device=K.device)
    return K
