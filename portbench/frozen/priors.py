"""Prior arithmetic, a frozen copy of hdpgpc_torch/data/priors.py's
``compute_estimators_lds``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def compute_estimators_lds(samples: np.ndarray, n_f: Optional[int] = None
                           ) -> Tuple[float, float, Tuple[float, float],
                                      Tuple[float, float]]:
    """samples (N, T, L >= 1) -> (std, std_dif, bound_std,
    bound_std_dif): mean within-beat variance and one-step difference
    variance over the first n_f beats, x0.02 when std > 1, std_dif
    clamped to [std, 1.5 std]."""
    if n_f is None:
        n_f = samples.shape[0] - 2
    s0 = samples[:n_f][:, :, 0].T
    s1 = samples[1:n_f + 1][:, :, 0].T
    centred = s0 - np.mean(s0, axis=1)[:, None]
    std = float(np.mean(np.diag(centred @ centred.T)) / n_f)
    d = s1 - s0
    std_dif = float(np.mean(np.diag(d @ d.T)) / n_f)
    if std > 1:
        std *= 0.02
        std_dif *= 0.02
    std_dif = float(np.min([np.max([std, std_dif]), std * 1.5]))
    bound_std = (std * 1e-5, std * 2.0)
    bound_std_dif = (std_dif * 1e-5, 1.0)
    return std, std_dif, bound_std, bound_std_dif
