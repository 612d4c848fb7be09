"""Quantile binning for the histogram GBDT (port of
``mallorn_tpu.trees.binning``).

Bin edges come from per-feature quantiles computed on the host with
numpy (``fit_bins``; ``fit_bins_folds`` for the K folds of a CV from one
shared sort); assigning bins is a device op (``apply_bins``;
``apply_bins_folds_gather`` for every fold's rows of one parent matrix):
bin = number of edges <= x, NaN -> the missing bin ``n_bins``.
"""

from __future__ import annotations

import hashlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


# the most value bins a fit takes: bin ids, the missing bin n_bins
# included, are int16 on every histogram kernel (ops/hist_cuda.py), so
# 32,768 bins would wrap the missing bin negative
MAX_N_BINS = 32767


def check_n_bins(n_bins: int) -> int:
    """``n_bins`` as an int; raises beyond MAX_N_BINS."""
    if int(n_bins) > MAX_N_BINS:
        raise ValueError(f"n_bins = {n_bins}: the port takes at most {MAX_N_BINS} value bins, "
                         f"because bin ids, the missing bin n_bins included, are int16 on "
                         f"every histogram kernel")
    return int(n_bins)


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
    gives weighted quantiles (inverted weighted CDF). Raises for more than
    MAX_N_BINS bins."""
    n_bins = check_n_bins(n_bins)
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


# content-keyed memo for fit_bins_folds: repeated pipeline passes over the
# same matrices reuse their edges instead of re-sorting; bounded, keyed on
# a digest of every input (the JAX package keeps the same memo)
_FOLD_BINS_MEMO: dict = {}


def _fold_bins_key(X, fold_idx, n_bins, sample_weights, device) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(X).tobytes())
    for idx in fold_idx:
        h.update(np.ascontiguousarray(np.asarray(idx, np.int64)).tobytes())
        h.update(b"|")
    if sample_weights is not None:
        for w in sample_weights:
            h.update(np.ascontiguousarray(np.asarray(w, np.float32)).tobytes())
            h.update(b"|")
    h.update(f"{n_bins}|{device}".encode())
    return h.hexdigest()


def fit_bins_folds(X: np.ndarray, fold_idx: Sequence[np.ndarray], n_bins: int = 256,
                   sample_weights: Optional[Sequence[np.ndarray]] = None,
                   device: DeviceLike = None) -> List[BinSpec]:
    """Per-fold quantile edges from ONE stable per-column sort of X [n, F].

    Equal to ``[fit_bins(X[idx], n_bins, w) for idx, w in zip(fold_idx,
    sample_weights)]``: a stable global sort restricted to a fold's rows is
    that fold's own stable sort, so each fold pays a boolean gather and a
    cumsum. Memoised on a digest of the inputs; treat the specs as
    read-only. Raises for more than MAX_N_BINS bins."""
    n_bins = check_n_bins(n_bins)
    X = np.asarray(X, dtype=np.float64)
    dev = resolve_device(device)
    key = _fold_bins_key(X, fold_idx, n_bins, sample_weights, dev)
    hit = _FOLD_BINS_MEMO.get(key)
    if hit is not None:
        return hit
    X = np.clip(X, -1e10, 1e10)
    n, f = X.shape
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    order = np.argsort(X, axis=0, kind="stable")  # NaNs sort last
    Xs = np.take_along_axis(X, order, axis=0)
    finite_s = ~np.isnan(Xs)

    specs = []
    for k, idx in enumerate(fold_idx):
        idx = np.asarray(idx)
        w = None if sample_weights is None else np.asarray(sample_weights[k])
        weighted = w is not None and not np.allclose(w, w.flat[0])
        member = np.zeros(n, bool)
        member[idx] = True
        keep = member[order] & finite_s  # [n, F]
        c = np.cumsum(keep, axis=0)  # kept-finite counts
        nf = c[-1]
        q = np.full((f, len(qs)), np.nan)
        if weighted:
            wg = np.zeros(n, np.float64)
            wg[idx] = w
            cw = np.cumsum(np.where(keep, wg[order], 0.0), axis=0)
            tot = cw[-1]
            for j in np.nonzero(tot > 0)[0]:
                # the first row reaching a target weight is a kept row
                pos = np.searchsorted(cw[:, j], qs * tot[j], side="left")
                last = np.searchsorted(c[:, j], nf[j], side="left")
                q[j] = Xs[np.minimum(pos, last), j]
        else:
            pos = qs[None, :] * (np.maximum(nf, 1)[:, None] - 1)
            lo = np.floor(pos).astype(np.int64)
            hi = np.minimum(lo + 1, np.maximum(nf[:, None] - 1, 0))
            frac = pos - lo
            for j in np.nonzero(nf > 0)[0]:
                # kept rank r sits at the first row whose kept count is r + 1
                vlo = Xs[np.searchsorted(c[:, j], lo[j] + 1, side="left"), j]
                vhi = Xs[np.searchsorted(c[:, j], hi[j] + 1, side="left"), j]
                diff = vhi - vlo  # numpy's _lerp: from b when t >= 0.5
                q[j] = np.where(frac[j] >= 0.5, vhi - diff * (1 - frac[j]),
                                vlo + diff * frac[j])
        edges = torch.from_numpy(_edges_from_quantiles(q, n_bins)).to(dev)
        specs.append(BinSpec(edges=edges, n_bins=n_bins))
    if len(_FOLD_BINS_MEMO) > 16:
        _FOLD_BINS_MEMO.clear()
    _FOLD_BINS_MEMO[key] = specs
    return specs


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


def apply_bins_folds_gather(X_parent: torch.Tensor, edges: torch.Tensor,
                            idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-fold row gather + bin assignment on the device.

    X_parent [n, F] float32, edges [K, F, n_bins-1] (each fold's ascending,
    inf-padded edges), idx [K, R] row indices into X_parent (negative =
    padding). Returns [K, R, F] int16: fold k's bins of row ``idx[k, r]``,
    0 on padded rows, the missing bin ``n_bins`` for NaN."""
    K, R = idx.shape
    valid = idx >= 0
    x = X_parent[idx.clamp(0, X_parent.shape[0] - 1).long()]  # [K, R, F]
    xc = torch.clamp(x, -1e10, 1e10).transpose(1, 2).contiguous()  # [K, F, R]
    b = torch.searchsorted(edges.contiguous(), xc, right=True).transpose(1, 2)
    b = torch.where(torch.isnan(x), n_bins, b)
    return torch.where(valid[:, :, None], b, 0).to(torch.int16)
