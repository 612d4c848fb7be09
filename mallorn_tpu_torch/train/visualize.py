"""Figures of a training run, written as PNG files with matplotlib (port
of ``mallorn_tpu.train.visualize``): the confusion matrix, gain
importance, the class-split prediction histogram, the adversarial weights
and one object's lightcurve.

Every function writes a PNG to ``path`` and returns the path. matplotlib
is imported inside the call, headless (the Agg backend), so the module
imports without it; ``plot_lightcurve`` reads the port's
``PackedLightcurves`` tensors through ``.cpu()``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from mallorn_tpu_torch.utils.constants import LSST_BANDS


def _plt():
    import matplotlib

    matplotlib.use("Agg")  # headless
    import matplotlib.pyplot as plt

    return plt


def plot_confusion(y, preds, threshold: float, path) -> Path:
    """2x2 confusion-matrix heatmap at a threshold."""
    plt = _plt()
    y = np.asarray(y).astype(int)
    b = (np.asarray(preds) > threshold).astype(int)
    m = np.array([[(1 - y)[b == 0].sum(), (1 - y)[b == 1].sum()],
                  [y[b == 0].sum(), y[b == 1].sum()]], dtype=float)
    fig, ax = plt.subplots(figsize=(4, 3.5))
    ax.imshow(m, cmap="Blues")
    for i in range(2):
        for j in range(2):
            ax.text(j, i, f"{int(m[i, j])}", ha="center", va="center")
    ax.set_xticks([0, 1], ["pred non-TDE", "pred TDE"])
    ax.set_yticks([0, 1], ["true non-TDE", "true TDE"])
    ax.set_title(f"confusion @ {threshold:.3f}")
    return _save(fig, path)


def plot_importance(names: Sequence[str], gains, path, top_k: int = 25) -> Path:
    """Horizontal gain-importance bars (train_v34a_bazin.py:224-247 table
    as a figure)."""
    plt = _plt()
    gains = np.asarray(gains, float)
    order = np.argsort(gains)[::-1][:top_k][::-1]
    fig, ax = plt.subplots(figsize=(7, 0.3 * len(order) + 1.2))
    ax.barh(range(len(order)), gains[order])
    ax.set_yticks(range(len(order)), [names[i] for i in order], fontsize=7)
    ax.set_xlabel("gain")
    ax.set_title("feature importance (gain)")
    return _save(fig, path)


def plot_prediction_distribution(preds, y, threshold: Optional[float],
                                 path) -> Path:
    """Class-split histogram of predicted probabilities."""
    plt = _plt()
    preds = np.asarray(preds)
    y = np.asarray(y).astype(int)
    fig, ax = plt.subplots(figsize=(6, 3.5))
    bins = np.linspace(0, 1, 40)
    ax.hist(preds[y == 0], bins=bins, alpha=0.6, label="non-TDE", log=True)
    ax.hist(preds[y == 1], bins=bins, alpha=0.6, label="TDE", log=True)
    if threshold is not None:
        ax.axvline(threshold, color="k", ls="--", lw=1,
                   label=f"threshold {threshold:.3f}")
    ax.set_xlabel("p(TDE)")
    ax.legend()
    return _save(fig, path)


def plot_adversarial_weights(weights, path) -> Path:
    """Histogram of adversarial sample weights (0.5 + 1.5p map)."""
    plt = _plt()
    w = np.asarray(weights)
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.hist(w, bins=40)
    ax.set_xlabel("sample weight")
    ax.set_title(f"adversarial weights [{w.min():.2f}, {w.max():.2f}]")
    return _save(fig, path)


def plot_lightcurve(packed, index: int, path,
                    object_id: Optional[str] = None) -> Path:
    """Per-band flux-vs-time scatter with errorbars for one object."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    t = packed.band_time[index].cpu().numpy()
    f = packed.band_flux[index].cpu().numpy()
    e = packed.band_err[index].cpu().numpy()
    m = packed.band_mask[index].cpu().numpy()
    for b, name in enumerate(LSST_BANDS):
        sel = m[b]
        if sel.any():
            ax.errorbar(t[b][sel], f[b][sel], yerr=e[b][sel], fmt="o",
                        ms=3, lw=0.7, label=name)
    ax.set_xlabel("time (d)")
    ax.set_ylabel("flux")
    ax.legend(ncols=6, fontsize=7)
    if object_id:
        ax.set_title(str(object_id))
    return _save(fig, path)


def _save(fig, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path
