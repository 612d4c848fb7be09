"""Probability calibration over OOF predictions: Platt scaling, isotonic
regression and threshold-variant submissions (port of
``mallorn_tpu.train.calibration``; host numpy, as in the JAX package).

``isotonic_calibrate`` replaces scikit-learn's
``IsotonicRegression(out_of_bounds="clip")``, which the machine with the
card does not have, with the same algorithm: rows sorted by (x, y), tied x
values merged into one point whose y is their mean, pool-adjacent-violators
for the increasing fit, the points inside runs of equal fitted values
dropped, and prediction by linear interpolation between the remaining
points after clipping to the training range of x.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def platt_scale(oof: np.ndarray, y: np.ndarray, preds: np.ndarray,
                n_iter: int = 200, lr: float = 0.1):
    """Fit sigmoid(a logit(p) + b) on OOF by gradient descent, apply to
    ``preds``; returns (calibrated preds, (a, b))."""
    eps = 1e-7
    z = np.log(np.clip(oof, eps, 1 - eps) / np.clip(1 - oof, eps, 1 - eps))
    a, b = 1.0, 0.0
    for _ in range(n_iter):
        p = 1.0 / (1.0 + np.exp(-(a * z + b)))
        ga = np.mean((p - y) * z)
        gb = np.mean(p - y)
        a -= lr * ga
        b -= lr * gb
    zt = np.log(np.clip(preds, eps, 1 - eps) / np.clip(1 - preds, eps, 1 - eps))
    return 1.0 / (1.0 + np.exp(-(a * zt + b))), (a, b)


def _pool_adjacent_violators(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The increasing least-squares fit of ``y`` with weights ``w``: blocks
    of adjacent points merged while a block's mean exceeds the next's."""
    sums, weights, sizes = [], [], []
    for yi, wi in zip(np.asarray(y, np.float64) * w, np.asarray(w, np.float64)):
        sums.append(yi)
        weights.append(wi)
        sizes.append(1)
        while len(sums) > 1 and sums[-2] / weights[-2] >= sums[-1] / weights[-1]:
            s, wt, n = sums.pop(), weights.pop(), sizes.pop()
            sums[-1] += s
            weights[-1] += wt
            sizes[-1] += n
    return np.repeat(np.asarray(sums) / np.asarray(weights), sizes).astype(y.dtype)


def _isotonic_fit(x: np.ndarray, y: np.ndarray):
    """(thresholds x, fitted y at them, x min, x max) of the increasing
    isotonic regression of ``y`` on ``x``, in x's float dtype (float32
    stays float32, anything else is float64)."""
    x = np.asarray(x).reshape(-1)
    dtype = x.dtype if x.dtype in (np.float32, np.float64) else np.float64
    x = x.astype(dtype)
    y = np.asarray(y).reshape(-1).astype(dtype)
    order = np.lexsort((y, x))
    x, y = x[order], y[order]
    # tied x values: one point, y their mean
    ux, start, counts = np.unique(x, return_index=True, return_counts=True)
    uy = np.add.reduceat(y, start) / counts if len(x) else y
    fit = _pool_adjacent_violators(uy.astype(dtype), counts.astype(dtype))
    # drop the points inside runs of equal fitted values
    keep = np.ones(len(fit), bool)
    keep[1:-1] = (fit[1:-1] != fit[:-2]) | (fit[1:-1] != fit[2:])
    return ux[keep], fit[keep], ux.min(), ux.max()


def isotonic_calibrate(oof: np.ndarray, y: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """Isotonic calibration: fit on (oof, y), predict ``preds`` clipped to
    the OOF range, linear between the fitted points."""
    xs, ys, lo, hi = _isotonic_fit(oof, y)
    t = np.clip(np.asarray(preds).reshape(-1).astype(xs.dtype), lo, hi)
    if len(xs) == 1:
        return np.repeat(ys, len(t))
    if xs.dtype == np.float64:
        return np.interp(t, xs, ys)
    # float32 points: the segment's slope in float32, as scipy's interp1d
    hi_i = np.clip(np.searchsorted(xs, t), 1, len(xs) - 1)
    x_lo, y_lo = xs[hi_i - 1], ys[hi_i - 1]
    slope = (ys[hi_i] - y_lo) / (xs[hi_i] - x_lo)
    return (slope * (t - x_lo) + y_lo).astype(xs.dtype)


def threshold_variants(preds: np.ndarray,
                       thresholds: Sequence[float]) -> Dict[float, np.ndarray]:
    """Binary submissions at several thresholds."""
    return {float(t): (preds > t).astype(int) for t in thresholds}
