"""Quantile binning for the histogram GBDT (port of
``mallorn_tpu.trees.binning``, serving side plus the host edge fit).

Bin edges come from per-feature quantiles computed on the host with
numpy (``fit_bins``); assigning bins is a device op (``apply_bins``):
bin = number of edges <= x, NaN -> the missing bin ``n_bins``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


class BinSpec(NamedTuple):
    edges: torch.Tensor  # [F, n_bins-1] f32 ascending split points (inf-padded)
    n_bins: int  # number of value bins; bin id n_bins is "missing"

    @property
    def missing_bin(self) -> int:
        return self.n_bins


def fit_bins(X: np.ndarray, n_bins: int = 256,
             sample_weight: Optional[np.ndarray] = None,
             device: DeviceLike = None) -> BinSpec:
    """Per-feature quantile edges from the finite values of X [N, F].

    +-inf is clamped to +-1e10 first; a non-uniform ``sample_weight``
    gives weighted quantiles (inverted weighted CDF)."""
    X = np.clip(np.asarray(X, dtype=np.float64), -1e10, 1e10)
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    weighted = (sample_weight is not None
                and not np.allclose(sample_weight, sample_weight.flat[0]))
    if weighted:
        q = _weighted_quantiles(X, np.asarray(sample_weight, np.float64), qs)
    else:
        q = _uniform_quantiles(X, qs)
    edges = torch.from_numpy(_edges_from_quantiles(q, n_bins))
    return BinSpec(edges=edges.to(resolve_device(device)), n_bins=n_bins)


def _edges_from_quantiles(q: np.ndarray, n_bins: int) -> np.ndarray:
    f = q.shape[0]
    edges = np.full((f, n_bins - 1), np.inf, dtype=np.float32)
    all_nan = np.isnan(q).all(axis=1)
    for j in np.nonzero(~all_nan)[0]:
        e = np.unique(q[j][np.isfinite(q[j])])
        edges[j, : len(e)] = e
    # features with no finite values: every row routes to the missing bin
    edges[all_nan] = np.arange(n_bins - 1, dtype=np.float32)
    return edges


def _uniform_quantiles(X: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """``np.nanquantile(X, qs, axis=0).T`` (linear), vectorised."""
    Xs = np.sort(X, axis=0)  # NaNs sort last
    nf = np.sum(~np.isnan(X), axis=0)
    pos = qs[None, :] * (np.maximum(nf, 1)[:, None] - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, np.maximum(nf[:, None] - 1, 0))
    frac = pos - lo
    vlo = np.take_along_axis(Xs, lo.T, axis=0).T
    vhi = np.take_along_axis(Xs, hi.T, axis=0).T
    diff = vhi - vlo  # numpy's _lerp: from b when t >= 0.5
    out = np.where(frac >= 0.5, vhi - diff * (1 - frac), vlo + diff * frac)
    out[nf == 0] = np.nan
    return out


def _weighted_quantiles(X: np.ndarray, w: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Weighted quantiles per feature (inverted CDF over finite rows)."""
    n, f = X.shape
    order = np.argsort(X, axis=0, kind="stable")
    Xs = np.take_along_axis(X, order, axis=0)
    Ws = np.take_along_axis(np.broadcast_to(w[:, None], (n, f)), order, axis=0)
    Ws = np.where(np.isnan(Xs), 0.0, Ws)
    cw = np.cumsum(Ws, axis=0)
    tot = cw[-1]
    out = np.full((f, len(qs)), np.nan)
    targets = qs[None, :] * tot[:, None]
    for j in np.nonzero(tot > 0)[0]:
        idx = np.searchsorted(cw[:, j], targets[j], side="left")
        nf = int(np.sum(~np.isnan(Xs[:, j])))
        if nf:
            out[j] = Xs[np.clip(idx, 0, nf - 1), j]
    return out


def apply_bins(spec: BinSpec, X: torch.Tensor) -> torch.Tensor:
    """[N, F] float -> [N, F] int32 bin ids in [0, n_bins] on X's device."""
    Xc = torch.clamp(X, -1e10, 1e10)
    b = torch.searchsorted(spec.edges.contiguous(), Xc.T.contiguous(), right=True)
    b = b.T.to(torch.int32)
    return torch.where(torch.isnan(X), spec.n_bins, b).to(torch.int32)
