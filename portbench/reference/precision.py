"""The control's precision: every product of two matrices rounds its
float32 operands to TF32 (10 explicit mantissa bits, round to nearest
even), as the card's tensor cores do when TF32 is on; everything else
stays float32. The reference run in float32 under ``tf32()`` is the
control: the precision below the float32, TF32 off, that the
configurations state. (cuBLAS keeps these small batched products on its
float32 kernels even with TF32 allowed, so the rounding is done here.)"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

MATMULS = {torch.matmul, torch.bmm, torch.mm, torch.Tensor.__matmul__,
           torch.Tensor.__rmatmul__, torch.Tensor.matmul}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to the nearest TF32 value (ties to even)."""
    if x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = (b + 0x0FFF + lsb) & ~0x1FFF
    return r.view(torch.float32)


class _TF32(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in MATMULS:
            args = tuple(to_tf32(a) if torch.is_tensor(a) else a
                         for a in args)
        return func(*args, **kwargs)


def tf32():
    """Context in which every matrix product is TF32."""
    return _TF32()
