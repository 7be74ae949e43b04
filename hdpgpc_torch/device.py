"""The device an entry point runs on.

Entry points (``HDPGPC``, ``fit_kernel``, ``fit_kernel_batch``) run on
the card unless the caller asks for the CPU: their ``device`` defaults
to "cuda", and ``resolve_device`` raises when torch sees no card. There
is no silent fall back to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but torch sees no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
