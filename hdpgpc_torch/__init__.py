"""hdpgpc_torch: HDP-GPC on PyTorch, with hand-written CUDA kernels.

The PyTorch/CUDA counterpart of ``hdpgpc_tpu`` (Hierarchical Dirichlet
Process Gaussian Process Clustering of fixed-length time-series
segments such as ECG heartbeats). The module layout and public names
follow ``hdpgpc_tpu``; ``hdpgpc_tpu`` stays the numerical reference
that the tests hold this package against.

Devices and dtypes are explicit: ``HDPGPC(..., device="cuda")`` puts
every tensor on the card (and raises when there is none), and every
tensor is created with an explicit dtype (float64 by default,
``compute_dtype="float32"`` for the speed mode). The global default
dtype is left alone.

Float32 matrix products must run in full float32: the Cholesky chains
of the refit lose their SPD structure in TF32 (three decimal digits).
The switches below are the counterpart of the TPU ``Precision.HIGHEST``
pins of ``hdpgpc_tpu`` (ops/pallas/chol_solve.py, ops/linalg.py).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from hdpgpc_torch.config import GPConfig, HDPConfig, ModelConfig  # noqa: E402


def __getattr__(name):
    if name == "HDPGPC":
        from hdpgpc_torch.models.hdpgpc import HDPGPC
        return HDPGPC
    raise AttributeError(name)


__all__ = ["GPConfig", "HDPConfig", "ModelConfig", "HDPGPC", "__version__"]
