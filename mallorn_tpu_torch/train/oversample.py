"""Minority-class oversampling, SMOTE and ADASYN (port of
``mallorn_tpu.train.oversample``; host numpy, the JAX package's code).

Each synthetic row interpolates a minority row toward one of its k nearest
minority neighbours (distances over median-imputed, std-scaled columns);
ADASYN allocates the synthetics by each minority row's share of majority
rows among its k nearest rows of either class. The random draws come from
``np.random.default_rng(seed)`` in the JAX package's order, so the output
is the JAX package's row for row."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _knn_minority(Xm: np.ndarray, k: int) -> np.ndarray:
    """Indices [n_min, k] of each minority sample's k nearest minority
    neighbors (NaNs imputed to column medians for the distance metric)."""
    Z = Xm.copy()
    med = np.nanmedian(Z, axis=0)
    med = np.where(np.isnan(med), 0.0, med)
    inds = np.where(np.isnan(Z))
    Z[inds] = np.take(med, inds[1])
    sd = Z.std(axis=0)
    Z = Z / np.where(sd > 0, sd, 1.0)
    d2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    k = min(k, len(Xm) - 1)
    return np.argsort(d2, axis=1)[:, :k]


def smote(X: np.ndarray, y: np.ndarray, k: int = 5, ratio: float = 1.0,
          seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Oversample the positive class to `ratio` x the majority count."""
    rng = np.random.default_rng(seed)
    pos = np.where(y == 1)[0]
    neg = np.where(y == 0)[0]
    n_new = int(ratio * len(neg)) - len(pos)
    if n_new <= 0 or len(pos) < 2:
        return X, y
    Xm = X[pos]
    nn = _knn_minority(Xm, k)
    base = rng.integers(0, len(pos), n_new)
    nbr = nn[base, rng.integers(0, nn.shape[1], n_new)]
    lam = rng.uniform(0, 1, (n_new, 1))
    X_new = Xm[base] + lam * (Xm[nbr] - Xm[base])
    return (np.vstack([X, X_new]),
            np.concatenate([y, np.ones(n_new, y.dtype)]))


def adasyn(X: np.ndarray, y: np.ndarray, k: int = 5, ratio: float = 1.0,
           seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """ADASYN: synthetics allocated proportionally to each minority
    sample's local majority density."""
    rng = np.random.default_rng(seed)
    pos = np.where(y == 1)[0]
    neg = np.where(y == 0)[0]
    n_new = int(ratio * len(neg)) - len(pos)
    if n_new <= 0 or len(pos) < 2:
        return X, y

    # local difficulty: fraction of majority among k nearest (all-class)
    Z = X.copy()
    med = np.nanmedian(Z, axis=0)
    med = np.where(np.isnan(med), 0.0, med)
    inds = np.where(np.isnan(Z))
    Z[inds] = np.take(med, inds[1])
    sd = Z.std(axis=0)
    Z = Z / np.where(sd > 0, sd, 1.0)
    d2 = ((Z[pos][:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    d2[np.arange(len(pos)), pos] = np.inf
    kk = min(k, len(y) - 1)
    nbrs = np.argsort(d2, axis=1)[:, :kk]
    difficulty = (y[nbrs] == 0).mean(axis=1)
    if difficulty.sum() == 0:
        difficulty = np.ones_like(difficulty)
    alloc = np.round(difficulty / difficulty.sum() * n_new).astype(int)

    Xm = X[pos]
    nn = _knn_minority(Xm, k)
    rows = np.repeat(np.arange(len(pos)), alloc)
    if len(rows) == 0:
        return X, y
    nbr = nn[rows, rng.integers(0, nn.shape[1], len(rows))]
    lam = rng.uniform(0, 1, (len(rows), 1))
    X_new = Xm[rows] + lam * (Xm[nbr] - Xm[rows])
    return (np.vstack([X, X_new]),
            np.concatenate([y, np.ones(len(rows), y.dtype)]))
