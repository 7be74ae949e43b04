"""The port's entry points run on the card unless the caller asks for
the CPU: with no ``device`` argument, ``HDPGPC``, ``fit_kernel`` and
``fit_kernel_batch`` take "cuda", and raise where torch sees no card
instead of running on the CPU."""

import numpy as np
import pytest
import torch

from hdpgpc_torch.data.loader import default_x_basis
from hdpgpc_torch.models import kernel_fit
from hdpgpc_torch.models.hdpgpc import HDPGPC


def _fit(fn):
    y = np.sin(np.arange(12) / 3.0)
    x = np.arange(12, dtype=np.float64)
    if fn == "fit_kernel":
        return kernel_fit.fit_kernel(x, y, (1e-4, 10.0), max_iters=2)
    return kernel_fit.fit_kernel_batch(x, np.stack([y, 2 * y]),
                                       (1e-4, 10.0), max_iters=2)[0]


def test_hdpgpc_defaults_to_the_card():
    if torch.cuda.is_available():
        assert HDPGPC(default_x_basis(12)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HDPGPC(default_x_basis(12))
    assert HDPGPC(default_x_basis(12), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("fn", ["fit_kernel", "fit_kernel_batch"])
def test_kernel_fit_defaults_to_the_card(fn):
    if torch.cuda.is_available():
        assert _fit(fn).outputscale.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _fit(fn)
