"""The float64 offline sweep's comparison: ``reference/offline.py``'s
float64 outputs and numbers, with a control in the precision just below
float64.

The program's state at the close of its last sweep is held to the
float64 reference as the float32 configuration's is. The control
stands in the program's place with the reference in float32 and TF32
off (every product in full float32, the forward-backward in float32):
the precision below the float64 that this configuration states, where
``reference/offline.py``'s control (float32 with TF32 products) is the
one below float32.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from portbench.reference import hmm
from portbench.reference import offline


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuBLAS and cuDNN products inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def control_capture(cap: Dict, cfg: Dict, device) -> Dict:
    """``cap`` with the program's outputs replaced by the reference's in
    float32, TF32 off; None when the reference finds no seed beat."""
    with full_float32():
        got = offline.reference_outputs(cap, cfg, device, torch.float32)
    if not got:
        return None
    clusters = [dict(cl, **st) for cl, st in zip(cap["clusters"],
                                                 got["states"])]
    fb = [(p, *hmm.fb_hard_idx(p, np.float32)) for p, _i, _q in cap["fb"]]
    return dict(cap, q=got["q"], q_lat=got["q_lat"], elbo=got["elbo"],
                glob=got["glob"], clusters=clusters, fb=fb)


def check(cap: Dict, cfg: Dict, device, control: bool = False
          ) -> Dict[str, float]:
    """The numbers of ``offline.check`` for ``cap`` (see there); with
    ``control`` for the float32, TF32-off reference in the program's
    place."""
    if control:
        cap = control_capture(cap, cfg, device)
        if cap is None:
            return {}
    return offline.check(cap, cfg, device)
