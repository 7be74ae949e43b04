"""Visualisation: cluster panels, MDS embedding, warps, ECG grids
(counterpart of hdpgpc_tpu.utils.plots).

Functional parity with the reference's util_plots (util_plots.py:
plot_models :301, plot_models_plotly :725, plot_MDS :598, plot_warp
:529, plot_ecg :106, plot_comparison :220) on matplotlib, imported when
a plot is drawn (the model path never imports it). plotly is not a
dependency: ``plot_models_plotly`` draws the same panels with
matplotlib, as hdpgpc_tpu's does. State tensors are read through
``.detach().cpu().numpy()``, so models on the card plot as well.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x) -> np.ndarray:
    """A state tensor (or array) as a float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _save(plt, fig, save):
    if save:
        fig.savefig(save, dpi=120)
        plt.close(fig)
        return save
    return fig


def plot_models(model, selected: Sequence[int], main_model, labels,
                n0: int = 0, save: Optional[str] = None, lead: int = 0,
                step: float = 0.1, plot_latent: bool = False):
    """Per-cluster panels: posterior observation mean with +-1.96 sigma
    bands (and latent band when requested), overlaid member beats."""
    plt = _mpl()
    num = len(selected)
    cols = int(np.ceil(np.sqrt(num)))
    rows = int(np.ceil(num / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(4.5 * cols, 3.2 * rows),
                             squeeze=False, sharey=True)
    x = model.x_basis
    y_all = getattr(model, "_y_all", None)
    for k, m in enumerate(selected):
        ax = axes[k // cols][k % cols]
        cl = model.clusters[lead][m]
        st = cl.state
        mean = (_np(st.C) @ _np(st.f_last))[:, 0]
        sig = np.sqrt(np.clip(np.diag(_np(st.Sigma)), 0, None))
        if y_all is not None and cl.members.size:
            sub = cl.members[:: max(1, cl.members.size // 40)]
            for i in sub:
                ax.plot(x, y_all[i, :, lead], color="0.8", lw=0.4, zorder=1)
        ax.plot(x, mean, color="C0", lw=1.8, zorder=3, label="obs mean")
        ax.fill_between(x, mean - 1.96 * sig, mean + 1.96 * sig,
                        color="C0", alpha=0.25, zorder=2)
        if plot_latent:
            lat = _np(st.f_sm_last)[:, 0]
            gsig = np.sqrt(np.clip(np.diag(_np(st.P_sm_last)), 0, None))
            ax.plot(x, lat, color="C1", lw=1.0, zorder=4, label="latent")
            ax.fill_between(x, lat - 1.96 * gsig, lat + 1.96 * gsig,
                            color="C1", alpha=0.15, zorder=2)
        title = f"Model {m + 1}"
        if main_model is not None and m < len(main_model):
            title += f" - {main_model[m]} (n={cl.members.size})"
        ax.set_title(title, fontsize=10)
    for k in range(num, rows * cols):
        axes[k // cols][k % cols].axis("off")
    fig.tight_layout()
    return _save(plt, fig, save)


def plot_models_plotly(model, selected, main_model, labels, n0=0,
                       save=None, lead=0, step=0.5, plot_latent=False):
    """The reference's entry point; draws plot_models' panels."""
    return plot_models(model, selected, main_model, labels, n0=n0,
                       save=save, lead=lead, step=step,
                       plot_latent=plot_latent)


def cluster_kl_matrix(model, lead: int = 0) -> np.ndarray:
    """Pairwise symmetric KL between cluster observation distributions
    (GPI.KL_divergence, GPI.py:1058-1094; GPI_model.KL_divergence,
    GPI_model.py:899-931), in float64 on the host."""
    sel = model.selected_gpmodels()
    K = len(sel)
    D = np.zeros((K, K))

    def moments(m):
        st = model.clusters[lead][m].state
        C = _np(st.C)
        mu = (C @ _np(st.f_sm_last))[:, 0]
        cov = C @ _np(st.P_sm_last) @ C.T + _np(st.Sigma)
        return mu, cov

    for a in range(K):
        mu1, c1 = moments(sel[a])
        for b in range(a + 1, K):
            mu2, c2 = moments(sel[b])
            ic1 = np.linalg.inv(c1)
            ic2 = np.linalg.inv(c2)
            tr = (np.trace(ic2 @ c1 + ic1 @ c2) - 2 * c1.shape[0]) / 4
            d = mu1 - mu2
            first = float(d @ (ic1 + ic2) @ d) / 4
            D[a, b] = D[b, a] = first + tr
    return D


def plot_mds(model, labels=None, lead: int = 0, save: Optional[str] = None,
             random_state: int = 42):
    """2-D MDS embedding of per-cluster KL distances
    (util_plots.plot_MDS, util_plots.py:598-724)."""
    from sklearn.manifold import MDS
    plt = _mpl()
    D = cluster_kl_matrix(model, lead)
    if D.shape[0] < 2:
        return None
    emb = MDS(n_components=2, dissimilarity="precomputed",
              random_state=random_state,
              normalized_stress="auto").fit_transform(D)
    sel = model.selected_gpmodels()
    sizes = np.array([model.clusters[lead][m].members.size for m in sel])
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.scatter(emb[:, 0], emb[:, 1], s=20 + 4 * sizes,
               c=np.arange(len(sel)), cmap="tab10", alpha=0.8)
    for i, m in enumerate(sel):
        ax.annotate(str(m + 1), emb[i], fontsize=9)
    ax.set_title("MDS of cluster KL distances")
    fig.tight_layout()
    return _save(plt, fig, save)


def plot_warp(x, x_warp, save: Optional[str] = None):
    """Warp offsets g(t) - t (util_plots.plot_warp, util_plots.py:529)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 3))
    for row in np.atleast_2d(_np(x_warp)):
        ax.plot(x, row, lw=0.8, alpha=0.7)
    ax.axhline(0.0, color="k", lw=0.5)
    ax.set_xlabel("t")
    ax.set_ylabel("warp offset")
    fig.tight_layout()
    return _save(plt, fig, save)


def plot_ecg(y, labels=None, fs: float = 360.0, save: Optional[str] = None,
             n_cols: int = 5):
    """ECG-grid beat gallery (util_plots.plot_ecg, util_plots.py:106)."""
    plt = _mpl()
    y = _np(y)
    n = min(y.shape[0], n_cols * 4)
    rows = int(np.ceil(n / n_cols))
    fig, axes = plt.subplots(rows, n_cols, figsize=(2.2 * n_cols,
                                                    1.8 * rows),
                             squeeze=False, sharey=True)
    for i in range(n):
        ax = axes[i // n_cols][i % n_cols]
        ax.plot(y[i, :, 0] if y.ndim == 3 else y[i], lw=0.8)
        if labels is not None:
            ax.set_title(str(labels[i]), fontsize=8)
        ax.grid(color="mistyrose", lw=0.4)
    for i in range(n, rows * n_cols):
        axes[i // n_cols][i % n_cols].axis("off")
    fig.tight_layout()
    return _save(plt, fig, save)


def plot_comparison(y_a, y_b, save: Optional[str] = None,
                    labels=("a", "b")):
    """Overlay two beat sets (util_plots.plot_comparison,
    util_plots.py:220)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 3))
    for row in np.atleast_2d(_np(y_a)):
        ax.plot(row, color="C0", alpha=0.5, lw=0.7)
    for row in np.atleast_2d(_np(y_b)):
        ax.plot(row, color="C3", alpha=0.5, lw=0.7)
    ax.legend(labels)
    fig.tight_layout()
    return _save(plt, fig, save)
