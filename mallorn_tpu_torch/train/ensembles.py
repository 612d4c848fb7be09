"""Ensembling utilities (port of ``mallorn_tpu.train.ensembles``): simple,
rank and weight-optimised blends, OOF stacking (v119) and the two-stage
classifier (v60).

- ``average_blend``: the (weighted) mean of prediction vectors;
- ``rank_average`` (ensemble_v38a): descending average ranks, averaged and
  rescaled to [0, 1];
- ``optimize_blend_weights`` (train_v125): grid-searched convex weights of
  two or three models maximising OOF F1;
- ``stack_oof`` (train_v119): a logistic-regression meta-learner on the
  base models' OOF columns (+ their mean and std), cross-validated so its
  predictions are out of fold;
- ``two_stage`` (train_v60): a stage-1 CV filters confident negatives,
  stage 2 retrains on the survivors.

The meta-learner is a small dense Newton solve in numpy; the folds come
from ``train.cv.stratified_kfold`` (scikit-learn's, without it).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import rankdata

from mallorn_tpu_torch.train.cv import stratified_kfold, threshold_sweep, train_cv
from mallorn_tpu_torch.trees.gbdt import GBDTParams
from mallorn_tpu_torch.utils.device import DeviceLike


def average_blend(preds: Sequence[np.ndarray],
                  weights: Optional[Sequence[float]] = None) -> np.ndarray:
    preds = np.stack([np.asarray(p) for p in preds])
    if weights is None:
        return preds.mean(axis=0)
    w = np.asarray(weights, dtype=np.float64)
    return (preds * w[:, None]).sum(axis=0) / w.sum()


def rank_average(preds: Sequence[np.ndarray]) -> np.ndarray:
    """Average of descending ranks (ties share their average rank),
    rescaled so rank 1 -> 1.0 and rank n -> 0.0 (ensemble_v38a_rank.py:65-90)."""
    ranks = [rankdata(-np.asarray(p), method="average") for p in preds]
    mean_rank = np.mean(ranks, axis=0)
    n = len(mean_rank)
    return (n - mean_rank) / (n - 1) if n > 1 else np.ones_like(mean_rank)


def optimize_blend_weights(oof_preds: Sequence[np.ndarray], y: np.ndarray,
                           n_grid: int = 21) -> Tuple[np.ndarray, float, float]:
    """Grid-searched convex weights of 2 or 3 models maximising OOF F1 (the
    first best wins). Returns (weights, best_f1, best_threshold)."""
    k = len(oof_preds)
    grid = np.linspace(0, 1, n_grid)
    best = (None, -1.0, 0.5)
    if k == 2:
        combos = [(w, 1 - w) for w in grid]
    elif k == 3:
        combos = [(a, b, 1 - a - b) for a in grid for b in grid if a + b <= 1]
    else:
        raise ValueError("optimize_blend_weights supports 2 or 3 models")
    for w in combos:
        f1, t = threshold_sweep(y, average_blend(oof_preds, w))
        if f1 > best[1]:
            best = (np.asarray(w), f1, t)
    return best


def _logreg_fit(X: np.ndarray, y: np.ndarray, l2: float = 1.0,
                n_iter: int = 50) -> np.ndarray:
    """L2-regularised logistic regression by Newton's method (the
    reference's LogisticRegression meta-learner,
    scripts/train_v119_stacking.py:33,143-163). Returns [d + 1] weights,
    the bias last."""
    n, d = X.shape
    A = np.concatenate([X, np.ones((n, 1))], axis=1)
    w = np.zeros(d + 1)
    for _ in range(n_iter):
        p = 1.0 / (1.0 + np.exp(-np.clip(A @ w, -30, 30)))
        g = A.T @ (p - y) + l2 * np.r_[w[:-1], 0.0]
        s = np.maximum(p * (1 - p), 1e-6)
        H = (A * s[:, None]).T @ A + l2 * np.diag(np.r_[np.ones(d), 0.0])
        step = np.linalg.solve(H, g)
        w = w - step
        if np.abs(step).max() < 1e-10:
            break
    return w


def _logreg_predict(w: np.ndarray, X: np.ndarray) -> np.ndarray:
    A = np.concatenate([X, np.ones((len(X), 1))], axis=1)
    return 1.0 / (1.0 + np.exp(-np.clip(A @ w, -30, 30)))


def stack_oof(oof_preds: Sequence[np.ndarray], y: np.ndarray,
              test_preds: Optional[Sequence[np.ndarray]] = None, n_folds: int = 5,
              seed: int = 42, l2: float = 1.0,
              add_agreement_features: bool = True) -> Dict[str, np.ndarray]:
    """Two-level stacking (train_v119): the base models' OOF columns (+ their
    mean and std, :151-163) feed a logistic-regression meta-learner over
    stratified folds, so its predictions are out of fold; the test
    predictions average the fold meta-models."""
    X_meta = np.column_stack([np.asarray(p, np.float64) for p in oof_preds])
    X_test = (np.column_stack([np.asarray(p, np.float64) for p in test_preds])
              if test_preds is not None else None)
    if add_agreement_features:
        X_meta = np.hstack([X_meta, X_meta.mean(1, keepdims=True),
                            X_meta.std(1, keepdims=True)])
        if X_test is not None:
            X_test = np.hstack([X_test, X_test.mean(1, keepdims=True),
                                X_test.std(1, keepdims=True)])
    y = np.asarray(y, np.float64)
    oof = np.zeros(len(y))
    test_acc = np.zeros(len(X_test)) if X_test is not None else None
    for tr, va in stratified_kfold(y, n_folds, seed):
        w = _logreg_fit(X_meta[tr], y[tr], l2=l2)
        oof[va] = _logreg_predict(w, X_meta[va])
        if X_test is not None:
            test_acc += _logreg_predict(w, X_test) / n_folds
    f1, thresh = threshold_sweep(y, oof)
    return {"oof_preds": oof, "test_preds": test_acc, "best_f1": f1, "threshold": thresh}


def two_stage(X_train: np.ndarray, y: np.ndarray, X_test: Optional[np.ndarray] = None,
              stage1_params: GBDTParams = GBDTParams(),
              stage2_params: GBDTParams = GBDTParams(),
              stage1_recall_threshold: float = 0.02,
              sample_weight: Optional[np.ndarray] = None,
              device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Two-stage pipeline (train_v60): a stage-1 CV keeps the objects whose
    OOF probability reaches ``stage1_recall_threshold`` (and every
    positive); stage 2 retrains on them. Filtered objects get probability
    0."""
    cv1 = train_cv(X_train, y, X_test, stage1_params, sample_weight=sample_weight,
                   device=device)
    survive = (cv1.oof_preds >= stage1_recall_threshold) | (y == 1)
    cv2 = train_cv(X_train[survive], y[survive], X_test, stage2_params,
                   sample_weight=sample_weight[survive] if sample_weight is not None else None,
                   device=device)
    oof = np.zeros(len(y))
    oof[survive] = cv2.oof_preds
    test_preds = None
    if X_test is not None:
        test_preds = np.where(cv1.test_preds >= stage1_recall_threshold, cv2.test_preds, 0.0)
    f1, thresh = threshold_sweep(y, oof)
    return {"oof_preds": oof, "test_preds": test_preds, "stage1_oof": cv1.oof_preds,
            "best_f1": f1, "threshold": thresh, "n_filtered": int((~survive).sum())}
