"""Prior estimation from a batch of beats.

Parity with the reference's ``compute_estimators_LDS``
(get_data.py:295-322): mean within-beat variance and 1-step difference
variance over the first n_f beats, with the x0.02 shrink when std > 1
and the clamp of std_dif to [std, 1.5 * std].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def compute_estimators_lds(samples: np.ndarray, n_f: Optional[int] = None
                           ) -> Tuple[float, float, Tuple[float, float],
                                      Tuple[float, float]]:
    """samples: (N, T, L>=1). Returns (std, std_dif, bound_std, bound_std_dif)."""
    if n_f is None:
        n_f = samples.shape[0] - 2
    s0 = samples[:n_f][:, :, 0].T          # (T, n_f)
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


def _median_torch(v: np.ndarray) -> float:
    """torch.median semantics: for an even element count, the LOWER of
    the two middle values (numpy averages them). The reference's
    redefine_default medians run over the 10 first-sample variances, so
    the even-length case is the one that matters — the numpy average
    shifted the reestimated Sigma by ~3% and rescaled every emission
    score on multi-lead records."""
    v = np.sort(np.asarray(v).ravel())
    return float(v[(v.shape[0] - 1) // 2])


def redefine_default_priors(y_trains: np.ndarray, estimation_limit=None
                            ) -> Tuple[float, float, Tuple[float, float],
                                       Tuple[float, float]]:
    """Batch re-estimation used by include_batch when
    reestimate_initial_params=True (GPI_HDP.redefine_default,
    GPI_HDP.py:1866-1904): medians over the first 10 samples per beat.
    """
    if estimation_limit is None:
        n_f = y_trains.shape[0] - 1
    else:
        n_f = min(int(estimation_limit), y_trains.shape[0] - 1)
    s = y_trains[:n_f][:, :10, 0].T          # (10, n_f)
    s_ = y_trains[1:n_f + 1][:, :10, 0].T
    c = s - np.mean(s, axis=1)[:, None]
    var_y = _median_torch(np.diag(c @ c.T)) / n_f
    d = s_ - s
    var_dy = _median_torch(np.diag(d @ d.T)) / n_f
    ini_sigma = var_y * 0.02
    ini_gamma = var_dy * 0.025
    bound_sigma = (ini_sigma * 1e-5, ini_sigma * 2.0)
    bound_gamma = (ini_gamma * 1e-5, ini_gamma * 2.0)
    return ini_sigma, ini_gamma, bound_sigma, bound_gamma
