"""Cross-validation and the OOF threshold sweep (port of
``mallorn_tpu.train.cv``).

Stratified 5-fold with ``random_state=42``; all folds train as one
batched fit (``train_gbdt_folds``); OOF margins come from the fit itself
(the best-iteration validation margins), test margins from one batched
forest pass; an F1-maximising threshold sweep runs on the OOF vector.

The machine with the card has no scikit-learn, so the fold assignment is
a numpy copy of ``StratifiedKFold(shuffle=True)._make_test_folds``: the
same ``np.random.RandomState`` calls in the same order give the same
folds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mallorn_tpu_torch.trees.gbdt import (GBDTModel, GBDTParams, predict_margin_models,
                                          train_gbdt_folds)
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


def stratified_kfold(y: np.ndarray, n_splits: int = 5, seed: int = 42
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train_idx, test_idx) per fold, equal to scikit-learn's
    ``StratifiedKFold(n_splits, shuffle=True, random_state=seed).split``."""
    rng = np.random.RandomState(seed)
    y = np.asarray(y).ravel()
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    # classes numbered by order of first appearance
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_enc = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_enc)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number "
                         "of members in each class.")
    y_order = np.sort(y_enc)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_enc == k] = folds_for_class
    idx = np.arange(len(y))
    return [(idx[test_folds != i], idx[test_folds == i]) for i in range(n_splits)]


def threshold_sweep(y: np.ndarray, probs: np.ndarray,
                    grid: Optional[np.ndarray] = None) -> Tuple[float, float]:
    """Best (f1, threshold) over ``grid`` (default np.linspace(0.05, 0.5,
    100)): f1 = 2tp / (2tp + fp + fn), 0 when undefined, the first grid
    point wins ties; (0.0, 0.5) when no threshold gives a positive F1."""
    if grid is None:
        grid = np.linspace(0.05, 0.5, 100)
    grid = np.asarray(grid, dtype=np.float64)
    y = np.asarray(y).astype(bool)
    probs = np.asarray(probs, dtype=np.float64)
    pred = probs[None, :] > grid[:, None]
    tp = (pred & y[None, :]).sum(axis=1)
    fp = (pred & ~y[None, :]).sum(axis=1)
    fn = ((~pred) & y[None, :]).sum(axis=1)
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2.0 * tp / np.maximum(denom, 1), 0.0)
    best = int(np.argmax(f1))
    if f1[best] <= 0.0:
        return 0.0, 0.5
    return float(f1[best]), float(grid[best])


def f1_score(y: np.ndarray, pred: np.ndarray) -> float:
    """Binary F1 of 0/1 predictions (0 when undefined)."""
    y, pred = np.asarray(y).astype(bool), np.asarray(pred).astype(bool)
    tp = int((y & pred).sum())
    denom = 2 * tp + int((~y & pred).sum()) + int((y & ~pred).sum())
    return 2.0 * tp / denom if denom else 0.0


@dataclasses.dataclass
class CVResult:
    oof_preds: np.ndarray  # [N_train] probabilities
    test_preds: Optional[np.ndarray]  # [N_test] fold-averaged probabilities
    fold_f1s: List[float]
    best_f1: float
    best_threshold: float
    importance_gain: np.ndarray  # [F] summed over folds
    models: List[GBDTModel]

    @property
    def rounds_run(self) -> int:
        """Boosting rounds the batched fit ran: until its last fold
        stopped (every round a fold ran has a finite metric)."""
        return max(int(np.isfinite(m.eval_history).sum()) for m in self.models)

    def confusion(self, y: np.ndarray) -> Dict[str, int]:
        pred = (self.oof_preds > self.best_threshold).astype(int)
        return {"tp": int(((pred == 1) & (y == 1)).sum()),
                "fp": int(((pred == 1) & (y == 0)).sum()),
                "fn": int(((pred == 0) & (y == 1)).sum()),
                "tn": int(((pred == 0) & (y == 0)).sum())}


def train_cv(X_train: np.ndarray, y: np.ndarray, X_test: Optional[np.ndarray] = None,
             params: GBDTParams = GBDTParams(),
             sample_weight: Optional[np.ndarray] = None,
             use_scale_pos_weight: bool = True, objective=None,
             sigmoid_outputs: bool = False, n_folds: int = 5,
             early_stopping_rounds: int = 50, seed: int = 42,
             threshold_grid: Optional[np.ndarray] = None,
             device: DeviceLike = None, verbose: bool = False) -> CVResult:
    """Stratified K-fold GBDT with OOF and fold-averaged test predictions.

    ``sigmoid_outputs``: a custom objective's raw margins take an explicit
    sigmoid (the built-in logistic objective always reports
    probabilities). The folds are row subsets of X_train, binned from one
    shared sort and one device gather, and train as one batched fit."""
    dev = resolve_device(device)
    X_parent = np.asarray(X_train, np.float32)
    y = np.asarray(y)
    splits = stratified_kfold(y, n_folds, seed)

    def fold_spw(yf):
        if not use_scale_pos_weight:
            return 1.0
        return float((yf == 0).sum() / max((yf == 1).sum(), 1))

    folds = [{"y": y[tr], "w": None if sample_weight is None else sample_weight[tr],
              "y_val": y[va], "spw": fold_spw(y[tr]), "seed": params.seed,
              "X_parent": X_parent, "tr_idx": tr, "va_idx": va}
             for tr, va in splits]
    models = train_gbdt_folds(
        folds, params, objective=objective, early_stopping_rounds=early_stopping_rounds,
        pad_rows_to=max(len(tr) for tr, _ in splits),
        pad_val_rows_to=max(len(va) for _, va in splits), device=dev)

    use_sigmoid = sigmoid_outputs or objective is None

    def link(m):
        return 1.0 / (1.0 + np.exp(-m)) if use_sigmoid else m

    test_margins = None
    if X_test is not None:
        Xt = torch.as_tensor(np.asarray(X_test, np.float32), device=dev)
        test_margins = predict_margin_models(models, Xt).cpu().numpy()
    if all(m.val_margin is not None for m in models):
        oof_margins = [m.val_margin for m in models]
    else:
        oof_margins = [predict_margin_models(
            [m], torch.as_tensor(X_parent[va], device=dev))[0].cpu().numpy()
            for m, (_, va) in zip(models, splits)]

    oof = np.zeros(len(y), dtype=np.float64)
    test_preds = None if X_test is None else np.zeros((len(X_test), n_folds))
    importance = None
    fold_f1s: List[float] = []
    for k, (model, (_, va)) in enumerate(zip(models, splits)):
        val_p = link(oof_margins[k][: len(va)])
        oof[va] = val_p
        if test_preds is not None:
            test_preds[:, k] = link(test_margins[k])
        imp = np.asarray(model.importance_gain)
        importance = imp if importance is None else importance + imp
        f1, t = threshold_sweep(y[va], val_p, np.linspace(0.05, 0.5, 50))
        fold_f1s.append(f1)
        if verbose:
            print(f"   fold {k + 1}/{n_folds}: best_iter={model.best_iteration} "
                  f"F1={f1:.4f} @ {t:.3f}", flush=True)
    best_f1, best_t = threshold_sweep(y, oof, threshold_grid)
    return CVResult(oof_preds=oof,
                    test_preds=test_preds.mean(axis=1) if test_preds is not None else None,
                    fold_f1s=fold_f1s, best_f1=best_f1, best_threshold=best_t,
                    importance_gain=importance, models=models)
