"""Data ingestion: MIT-BIH beat matrices and synthetic streams.

The reference bundles pre-segmented beats as ``<rec>.npy`` with shape
(n_beats, 90, 2) float64 plus ``<rec>_labels.npy`` (U1 symbols)
(reference hdpgpc/data/mitbih, produced by extract_data.py:16-33 with
window [60, 150] around R-87). We load those arrays directly; WFDB
re-segmentation is out of scope for the framework itself (the arrays
are the canonical fixture).

All loaders return static-shape float64 arrays; beat length is padded
to a static T if requested.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

_DEFAULT_DIRS = (
    os.environ.get("HDPGPC_DATA_DIR", ""),
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data", "mitbih"),
)

INCLUDED_LABELS = ['N', 'L', 'R', 'a', 'A', 'J', 'S', 'e', 'j', 'V', 'E',
                   'F', '/', 'f', 'Q', '!', 'n']


def _data_dir() -> str:
    for d in _DEFAULT_DIRS:
        if d and os.path.isdir(d):
            return d
    raise FileNotFoundError(
        "No MIT-BIH data directory found; set HDPGPC_DATA_DIR")


def list_records() -> List[str]:
    d = _data_dir()
    recs = sorted(f[:-4] for f in os.listdir(d)
                  if f.endswith(".npy") and not f.endswith("_labels.npy"))
    return recs


def load_record(rec: str, lead: Optional[int] = None,
                pad_to: Optional[int] = None,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Load (beats, labels). beats: (N, T, L) float64.

    ``lead``: select a single lead (keepdims). ``pad_to``: right-pad the
    beat axis to a static length with edge values.
    """
    d = _data_dir()
    data = np.load(os.path.join(d, f"{rec}.npy")).astype(np.float64)
    labels = np.load(os.path.join(d, f"{rec}_labels.npy"))
    if data.ndim == 2:
        data = data[:, :, None]
    if lead is not None:
        data = data[:, :, [lead]]
    if pad_to is not None and data.shape[1] < pad_to:
        pad = pad_to - data.shape[1]
        data = np.pad(data, ((0, 0), (0, pad), (0, 0)), mode="edge")
    return data, labels


def record_or_synthetic(rec: str, lead: Optional[int] = None,
                        beats: Optional[int] = None, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Record ``rec`` (``load_record``), its first ``beats`` beats; where
    there is no data directory or no such record, ``synthetic_beats``
    (record 100's 2272 beats of T = 90 unless ``beats`` is given, both
    leads unless ``lead`` is, 4 clusters, noise 0.05, ``seed``) with its
    generating labels. Returns (data (N, T, L), labels, synthetic)."""
    try:
        data, labels = load_record(rec, lead=lead)
        synthetic = False
    except FileNotFoundError:
        data, labels = synthetic_beats(
            beats or 2272, T=90, n_clusters=4,
            n_outputs=1 if lead is not None else 2, noise=0.05, seed=seed)
        synthetic = True
    if beats:
        data, labels = data[:beats], labels[:beats]
    return data, labels, synthetic


def default_x_basis(T: int) -> np.ndarray:
    """Time index support [0, T) as column vector (test_offline.py:60)."""
    return np.atleast_2d(np.arange(0, T, 1, dtype=np.float64)).T


def synthetic_beats(n: int, T: int = 90, n_clusters: int = 4,
                    n_outputs: int = 1, noise: float = 0.05,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic beat stream: Gaussian-bump morphologies with drift.

    Used by the 1M-beat / K=64 stress configs (BASELINE.json) and unit
    tests when the MIT-BIH fixtures are unavailable.
    """
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
            -0.5 * ((t[None, :] - centers[:, None] - shift) / widths[:, None]) ** 2)
        beats[:, :, ld] = tmpl[z] + noise * rng.standard_normal((n, T))
    return beats.astype(np.float64), z


def synthetic_growth_stream(n, T, n_clusters, seed, start_beat,
                            interval) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic beats where cluster c only appears after beat
    c * interval: a growth schedule, one new morphology every
    ``interval`` beats (examples/run_stress_stream.py, copied so that
    this package stands alone). Deterministic given (seed, start_beat).
    Returns y (n, T) and the generating labels z (n,)."""
    z_rng = np.random.default_rng(seed)
    z = z_rng.integers(0, n_clusters, size=n)
    # remap each beat's cluster into the currently-available set
    avail = 1 + (start_beat + np.arange(n)) // interval
    avail = np.minimum(avail, n_clusters)
    z = z % avail
    tmpl = growth_templates(T, n_clusters)
    noise_rng = np.random.default_rng(seed + 1)
    y = tmpl[z] + 0.03 * noise_rng.standard_normal((n, T))
    return y.astype(np.float64), z


def growth_templates(T, n_clusters) -> np.ndarray:
    """Fixed bank of smoothed-random morphologies (unit curves scaled to
    distinct amplitudes), near-orthogonal in R^T: every new morphology
    is far from every committed cluster, the regime in which the online
    birth rule (GPI_HDP.py:2464-2541) prefers birth over absorption.
    Overlapping Gaussian bumps (``synthetic_beats``) make the same rule
    absorb."""
    g = np.exp(-0.5 * ((np.arange(-6, 7)) / 2.0) ** 2)
    g /= g.sum()
    raw = np.random.default_rng(0).standard_normal((n_clusters, T + 12))
    sm = np.stack([np.convolve(r, g, mode="same")[6:6 + T] for r in raw])
    sm /= np.linalg.norm(sm, axis=1, keepdims=True)
    amps = np.random.default_rng(1).uniform(2.4, 6.0, n_clusters)
    return sm * amps[:, None] * np.sqrt(T) / 3.0


def segment_beats(signal: np.ndarray, annotations: np.ndarray,
                  window=(60, 150), r_offset: int = 87,
                  scale_type: str = "mean") -> np.ndarray:
    """Segment a continuous multi-lead signal into beat windows around
    annotation samples (the reference's extraction recipe,
    get_data.py:184-203 / extract_data.py:24: window [lo, hi] relative
    to annotation - r_offset).

    Scale modes (get_data.py:174-200):
    * ``all`` — pre-scale the WHOLE signal (column-standardise) before
      segmenting (the caller does this; here a no-op per beat);
    * ``single`` — standardise each beat;
    * ``first`` — standardise every beat by the FIRST beat's mean/std;
    * ``mean`` — per-beat mean subtraction;
    * anything else — raw.

    signal: (n_samples, n_leads); annotations: (n_beats,) R-peak sample
    indices. Returns (n_kept, hi - lo, n_leads) float64.
    """
    signal = np.atleast_2d(np.asarray(signal, np.float64))
    if signal.shape[0] < signal.shape[1]:
        signal = signal.T
    lo, hi = window
    beats = []
    first_mean = first_sd = None
    for a in np.asarray(annotations, np.int64):
        s = a - r_offset + lo
        e = a - r_offset + hi
        if s < 0 or e > signal.shape[0]:
            continue
        b = signal[s:e].copy()
        if first_mean is None:
            first_mean, first_sd = float(b.mean()), float(b.std())
        if scale_type == "mean":
            b -= b.mean(axis=0)
        elif scale_type == "single":
            sd = b.std(axis=0)
            b = (b - b.mean(axis=0)) / np.where(sd == 0, 1.0, sd)
        elif scale_type == "first":
            b = (b - first_mean) / (first_sd if first_sd else 1.0)
        beats.append(b)
    return np.asarray(beats, np.float64)


def reconcile_annotations(ann_test: np.ndarray, ann_ref: np.ndarray,
                          window: int = 60) -> np.ndarray:
    """Reconcile detector annotations against reference annotations
    (the XQRS-vs-atr repair of get_data.py:144-169, which uses
    wfdb.processing.compare_annotations with a 60-sample window):
    drop test annotations with no reference within ``window`` samples,
    add reference annotations with no matched test, return sorted.
    """
    ann_test = np.sort(np.asarray(ann_test, np.int64))
    ann_ref = np.sort(np.asarray(ann_ref, np.int64))
    if ann_ref.size == 0:
        return ann_test
    if ann_test.size == 0:
        return ann_ref
    # greedy one-to-one nearest matching within the window
    d = np.abs(ann_test[:, None] - ann_ref[None, :])
    matched_ref = np.full(ann_ref.shape[0], False)
    keep_test = np.full(ann_test.shape[0], False)
    order = np.argsort(d, axis=None)
    for flat in order:
        i, j = np.unravel_index(flat, d.shape)
        if d[i, j] > window:
            break
        if keep_test[i] or matched_ref[j]:
            continue
        keep_test[i] = True
        matched_ref[j] = True
    out = np.concatenate([ann_test[keep_test], ann_ref[~matched_ref]])
    return np.sort(out)


def take_standard_labels(data: np.ndarray, labels,
                         filter: Optional[List[str]] = None):
    """Filter beats to the standard MIT-BIH label set
    (get_data.take_standard_labels, get_data.py:251-293) — reference
    quirks preserved: rows with excluded labels are ZEROED but kept in
    ``data`` (the returned labels list is shorter than data), and NaNs
    are replaced by 0.

    Returns (data, data_2d, labels) exactly as the reference does.
    """
    included = INCLUDED_LABELS if filter is None else filter
    data = np.asarray(data, np.float64)
    labels = list(labels)
    subdata = np.zeros(data.shape)
    if data.ndim > 2:
        for d in range(data.shape[0]):
            if labels[d] in included:
                subdata[d] = np.nan_to_num(data[d], nan=0.0)
    else:
        for d in range(data.shape[0]):
            if labels[d] in included:
                subdata[d] = np.nan_to_num(data[d], nan=0.0)
    data = subdata
    labels = [lab for lab in labels if lab in included]
    if data.ndim > 2:
        data_2d = data
    else:
        data_2d = [np.atleast_2d(d).T for d in data]
    return data, data_2d, labels


_DB_PATHS = {
    "mitdb": "mitdb/",
    "ucr": "ucr/UCRArchive_2018/",
    "long-term": "long-term/mit-bih-long-term-ecg-database-1.0.0/",
    "fantasia": "fantasia-database-1.0.0/",
    "apnea": "apnea-ecg-database-1.0.0/",
    "stt": "stt-1.0.0/",
}


def get_data(database: str = "mitdb", record: str = "100", deriv=0,
             scale_data: bool = True, scale_type: str = "all",
             samples=(0, 220), ann: str = "atr",
             filter_labels: bool = True, data_root: Optional[str] = None,
             return_annotations: bool = False, return_snr: bool = False):
    """WFDB-record ingestion (get_data.get_data, get_data.py:20-233):
    load a raw record, reconcile annotations (atr symbols or an XQRS
    re-detection repaired against atr), segment beats around R-87 with
    the requested scaling mode, filter to the standard label set.

    Requires the optional ``wfdb`` package (not bundled in this image);
    raises ImportError with guidance otherwise. The bundled
    pre-segmented ``<rec>.npy`` fixtures via :func:`load_record` are the
    canonical path; this mirrors the reference's raw-data surface for
    parity. ``data_root`` (or HDPGPC_WFDB_DIR) points at the directory
    holding the database folders (get_data.py:24-33).
    """
    try:
        import wfdb
        from wfdb import processing
    except ImportError as e:              # pragma: no cover - env-gated
        raise ImportError(
            "get_data() needs the 'wfdb' package for raw record "
            "ingestion; use load_record() with the bundled .npy beat "
            "fixtures instead") from e
    root = data_root or os.environ.get("HDPGPC_WFDB_DIR", "")
    if database == "ucr":                 # pragma: no cover - env-gated
        path = os.path.join(root, _DB_PATHS["ucr"], record,
                            record + "_TRAIN.tsv")
        raw = np.genfromtxt(path, delimiter="\t")
        labels = raw[:, 0].astype(int)
        rows = raw[:, 1:].astype(np.float64)
        if scale_data:
            sd = rows.std(axis=1, keepdims=True)
            rows = (rows - rows.mean(axis=1, keepdims=True)) \
                / np.where(sd == 0, 1.0, sd)
        return rows, labels
    full_path = os.path.join(root, _DB_PATHS.get(database, database),
                             record)
    rec = wfdb.rdrecord(full_path, return_res=32, physical=False)
    labels_original = wfdb.rdann(full_path, "atr",
                                 return_label_elements=["symbol"]).symbol
    included = INCLUDED_LABELS
    labels = [l_ for l_ in labels_original
              if (not filter_labels) or l_ in included]
    if ann == "xqrs":
        sig, fields = wfdb.rdsamp(full_path, channels=[0])
        xqrs = processing.XQRS(sig=sig[:, 0], fs=fields["fs"])
        xqrs.detect()
        annotation = np.asarray(xqrs.qrs_inds)
        ann_atr = wfdb.rdann(full_path, "atr").sample
        ann_atr = np.asarray([a for a, l_ in zip(ann_atr, labels_original)
                              if (not filter_labels) or l_ in included])
        if len(labels) != len(annotation):
            annotation = reconcile_annotations(annotation, ann_atr, 60)
    else:
        ann_all = wfdb.rdann(full_path, "atr").sample
        annotation = np.asarray(
            [a for a, l_ in zip(ann_all, labels_original)
             if (not filter_labels) or l_ in included])
    # drop leading annotations whose window would underflow
    # (get_data.py:139-145)
    while annotation.size and annotation[0] - 87 + samples[0] < 0:
        annotation = annotation[1:]
        labels = labels[1:]
    signal = rec.d_signal.astype(np.float64)
    if scale_data and scale_type == "all":
        sd = signal.std(axis=0, keepdims=True)
        signal = (signal - signal.mean(axis=0, keepdims=True)) \
            / np.where(sd == 0, 1.0, sd)
    elif scale_data and scale_type == "mean_all":
        signal = signal - np.mean(signal)
    seg_scale = scale_type if scale_type in ("single", "first", "mean") \
        else "none"
    if deriv is not None:
        signal = signal[:, [deriv]]
    data = segment_beats(signal, annotation, window=tuple(samples),
                         r_offset=87, scale_type=seg_scale)
    if deriv is not None:
        data = data[:, :, 0]
    labels = np.array(labels)
    out = [data, labels]
    if return_annotations:
        out.append(annotation)
    if return_snr:
        out.append(signaltonoise(signal, axis=0))
    return tuple(out) if len(out) > 2 else (data, labels)


def signaltonoise(a: np.ndarray, axis: int = 0, ddof: int = 0) -> np.ndarray:
    """Mean^2 / var SNR (get_data.signaltonoise, get_data.py:243-248)."""
    a = np.asanyarray(a)
    m = a.mean(axis) ** 2
    sd = a.std(axis=axis, ddof=ddof) ** 2
    return np.where(sd == 0, 0, m / sd)


def rolling_snr(signal: np.ndarray, window_size: int) -> float:
    """Windowed SNR in dB (get_data.rolling_snr, get_data.py:235-241;
    GPI_HDP.rolling_snr, GPI_HDP.py:673-683) without pandas."""
    x = np.asarray(signal, np.float64)
    n = x.shape[0] - window_size + 1
    if n <= 1:
        return 0.0
    c = np.cumsum(np.insert(x, 0, 0.0))
    means = (c[window_size:] - c[:-window_size]) / window_size
    c2 = np.cumsum(np.insert(x * x, 0, 0.0))
    var = (c2[window_size:] - c2[:-window_size]) / window_size - means**2
    stds = np.sqrt(np.maximum(var * window_size / (window_size - 1), 0))
    mean_m = means[1:].mean()
    mean_s = stds[1:].mean()
    return float(10.0 * np.log10((mean_m**2)
                                 / max(mean_s**2, np.finfo(float).eps)))
