"""Traffic generators, frozen copies of hdpgpc_torch/data/loader.py's
``synthetic_beats``, ``synthetic_growth_stream`` and
``growth_templates``, plus ``fixed_morphology_beats`` (the same
morphologies in the same order for every seed, the noise from the
seed)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_beats(n: int, T: int = 90, n_clusters: int = 4,
                    n_outputs: int = 1, noise: float = 0.05,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian-bump morphologies with drift; morphologies, labels and
    noise all drawn from ``seed``. Returns beats (n, T, n_outputs) and
    the generating labels (n,)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, T)
    centers = rng.uniform(0.25, 0.75, size=n_clusters)
    widths = rng.uniform(0.03, 0.12, size=n_clusters)
    amps = rng.uniform(0.8, 2.0, size=n_clusters)
    z = rng.integers(0, n_clusters, size=n)
    beats = np.zeros((n, T, n_outputs))
    for ld in range(n_outputs):
        shift = 0.02 * ld
        tmpl = amps[:, None] * np.exp(
            -0.5 * ((t[None, :] - centers[:, None] - shift)
                    / widths[:, None]) ** 2)
        beats[:, :, ld] = tmpl[z] + noise * rng.standard_normal((n, T))
    return beats.astype(np.float64), z


def fixed_morphology_beats(n: int, T: int, n_clusters: int, noise: float,
                           morph_seed: int, seed: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """``synthetic_beats(n, T, n_clusters, noise=noise, seed=morph_seed)``
    with its noise drawn from ``seed`` instead: the morphologies and the
    order of the beats are the same for every seed, so a seed changes
    the record only by its noise (and the work the clustering does only
    as far as the noise moves it)."""
    mrng = np.random.default_rng(morph_seed)
    t = np.linspace(0.0, 1.0, T)
    centers = mrng.uniform(0.25, 0.75, size=n_clusters)
    widths = mrng.uniform(0.03, 0.12, size=n_clusters)
    amps = mrng.uniform(0.8, 2.0, size=n_clusters)
    z = mrng.integers(0, n_clusters, size=n)
    tmpl = amps[:, None] * np.exp(
        -0.5 * ((t[None, :] - centers[:, None]) / widths[:, None]) ** 2)
    beats = tmpl[z] + noise * np.random.default_rng(seed).standard_normal(
        (n, T))
    return beats[:, :, None].astype(np.float64), z


def synthetic_growth_stream(n, T, n_clusters, seed, start_beat,
                            interval) -> Tuple[np.ndarray, np.ndarray]:
    """Beats where cluster c only appears after beat c * interval, one
    new morphology every ``interval`` beats. Deterministic given (seed,
    start_beat). Returns y (n, T) and the generating labels z (n,)."""
    z_rng = np.random.default_rng(seed)
    z = z_rng.integers(0, n_clusters, size=n)
    avail = 1 + (start_beat + np.arange(n)) // interval
    avail = np.minimum(avail, n_clusters)
    z = z % avail
    tmpl = growth_templates(T, n_clusters)
    noise_rng = np.random.default_rng(seed + 1)
    y = tmpl[z] + 0.03 * noise_rng.standard_normal((n, T))
    return y.astype(np.float64), z


def growth_templates(T, n_clusters) -> np.ndarray:
    """Fixed bank of smoothed-random morphologies (unit curves scaled to
    distinct amplitudes), near-orthogonal in R^T."""
    g = np.exp(-0.5 * ((np.arange(-6, 7)) / 2.0) ** 2)
    g /= g.sum()
    raw = np.random.default_rng(0).standard_normal((n_clusters, T + 12))
    sm = np.stack([np.convolve(r, g, mode="same")[6:6 + T] for r in raw])
    sm /= np.linalg.norm(sm, axis=1, keepdims=True)
    amps = np.random.default_rng(1).uniform(2.4, 6.0, n_clusters)
    return sm * amps[:, None] * np.sqrt(T) / 3.0


def default_x_basis(T: int) -> np.ndarray:
    """Time index support [0, T) as a column."""
    return np.atleast_2d(np.arange(0, T, 1, dtype=np.float64)).T
