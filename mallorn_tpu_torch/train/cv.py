"""Cross-validation and the OOF threshold sweep (port of
``mallorn_tpu.train.cv``).

Stratified 5-fold with ``random_state=42``; all folds train as one
batched fit (``train_gbdt_folds``); OOF margins come from the fit itself
(the best-iteration validation margins), test margins from one batched
forest pass; an F1-maximising threshold sweep runs on the OOF vector.
``train_cv_multiclass`` is the K-class multi:softprob CV: OOF and
fold-averaged test class probabilities.

The machine with the card has no scikit-learn, so the fold assignment is
a numpy copy of ``StratifiedKFold(shuffle=True)._make_test_folds``: the
same ``np.random.RandomState`` calls in the same order give the same
folds.

A mesh enters through ``mesh=`` or, when that is None, the process's
default mesh (``parallel.mesh.default_mesh``; the command line's ``--mesh
N`` sets it in each rank): the batched fit then runs with every fold's
rows split over the ranks (``parallel.sharded_train.
train_gbdt_folds_sharded``), the same forests as on one device, on the
mesh's device. Every rank computes the whole result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mallorn_tpu_torch.parallel.mesh import Mesh, default_mesh
from mallorn_tpu_torch.trees.gbdt import (GBDTModel, GBDTParams, predict_margin_models,
                                          train_gbdt_folds)
from mallorn_tpu_torch.utils.device import DeviceLike, resolve_device


def _fit_folds(folds, params: GBDTParams, mesh: Optional[Mesh], dev, **kw) -> List[GBDTModel]:
    """The batched fit of the folds, on ``mesh`` when there is one."""
    if mesh is None:
        return train_gbdt_folds(folds, params, device=dev, **kw)
    from mallorn_tpu_torch.parallel.sharded_train import train_gbdt_folds_sharded

    return train_gbdt_folds_sharded(mesh, folds, params, **kw)


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


def softmax(m: np.ndarray) -> np.ndarray:
    """Softmax over the last axis (``exp(m - max) / sum``), in numpy."""
    e = np.exp(m - m.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def train_cv_multiclass(X_train: np.ndarray, y_class: np.ndarray,
                        X_test: Optional[np.ndarray] = None,
                        params: GBDTParams = GBDTParams(), n_folds: int = 5,
                        early_stopping_rounds: int = 50, seed: int = 42,
                        device: DeviceLike = None, mesh: Optional[Mesh] = None,
                        verbose: bool = False
                        ) -> Tuple[np.ndarray, Optional[np.ndarray], List[GBDTModel]]:
    """K-class multi:softprob CV: stratified K-fold on the class ids, all
    folds (and their classes, as lanes) in one batched fit early-stopped
    per fold on mlogloss; the OOF probabilities are the softmax of each
    fold's best-iteration validation margins (or of an explicit predict),
    the test probabilities the fold mean of the softmaxes.

    ``params.num_class`` must be >= 2; ``y_class`` holds class ids
    0..K-1. ``mesh`` (None: the default mesh): the folds' rows split over
    its ranks. Returns (oof_probs [N, K], test_probs [N_test, K] or None,
    models)."""
    if params.num_class < 2:
        raise ValueError("params.num_class must be >= 2")
    mesh = mesh if mesh is not None else default_mesh()
    dev = mesh.device if mesh is not None else resolve_device(device)
    y_class = np.asarray(y_class)
    K = params.num_class
    splits = stratified_kfold(y_class, n_folds, seed)
    X_parent = np.asarray(X_train, np.float32)
    folds = [{"y": y_class[tr].astype(np.float32), "w": None,
              "y_val": y_class[va].astype(np.float32), "spw": 1.0, "seed": params.seed,
              "X_parent": X_parent, "tr_idx": tr, "va_idx": va} for tr, va in splits]
    models = _fit_folds(
        folds, params, mesh, dev, early_stopping_rounds=early_stopping_rounds,
        pad_rows_to=max(len(tr) for tr, _ in splits),
        pad_val_rows_to=max(len(va) for _, va in splits))

    oof = np.zeros((len(y_class), K), np.float64)
    for model, (_, va) in zip(models, splits):
        if model.val_margin is not None:
            m = np.asarray(model.val_margin).T[:len(va)]
        else:
            m = predict_margin_models(
                [model], torch.as_tensor(X_parent[va], device=dev))[0].cpu().numpy()
        oof[va] = softmax(m)
    test_probs = None
    if X_test is not None:
        tm = predict_margin_models(
            models, torch.as_tensor(np.asarray(X_test, np.float32), device=dev))
        test_probs = softmax(tm.cpu().numpy()).mean(axis=0)  # [N_test, K]
    if verbose:
        acc = float((oof.argmax(-1) == y_class).mean())
        print(f"   [mc] OOF accuracy={acc:.4f} "
              f"best_iters={[m.best_iteration for m in models]}", flush=True)
    return oof, test_probs, models


def train_cv(X_train: np.ndarray, y: np.ndarray, X_test: Optional[np.ndarray] = None,
             params: GBDTParams = GBDTParams(),
             sample_weight: Optional[np.ndarray] = None,
             use_scale_pos_weight: bool = True, objective=None,
             sigmoid_outputs: bool = False, n_folds: int = 5,
             early_stopping_rounds: int = 50, seed: int = 42,
             threshold_grid: Optional[np.ndarray] = None,
             extra_train: Optional[Tuple] = None,
             y_train_soft: Optional[np.ndarray] = None,
             train_transform: Optional[Callable] = None,
             device: DeviceLike = None, mesh: Optional[Mesh] = None,
             verbose: bool = False) -> CVResult:
    """Stratified K-fold GBDT with OOF and fold-averaged test predictions.

    ``sigmoid_outputs``: a custom objective's raw margins take an explicit
    sigmoid (the built-in logistic objective always reports
    probabilities). The folds are row subsets of X_train, binned from one
    shared sort and one device gather, and train as one batched fit.

    ``extra_train``: ``(X_ext, y_ext[, w_ext])``, rows appended to every
    fold's training rows (weight 1 when not given) and never validated on;
    they join the shared parent matrix with their own row indices.

    ``y_train_soft``: float targets for the objective and for the
    early-stopping metric (the validation rows' soft targets too); the
    stratification, the fold and OOF F1s and the sweep stay on the hard
    ``y``.

    ``train_transform``: ``(X_f, y_f, w_f, fold_index) -> (X, y, w)`` on
    each fold's primary training rows (before ``extra_train`` is
    appended). A transformed fold carries its own matrices and bins on its
    own; scale_pos_weight then counts the transformed targets rounded at
    0.5.

    ``mesh`` (None: the default mesh): the folds' rows split over its
    ranks, on its device."""
    mesh = mesh if mesh is not None else default_mesh()
    dev = mesh.device if mesh is not None else resolve_device(device)
    X_parent = np.asarray(X_train, np.float32)
    y = np.asarray(y)
    y_soft = None if y_train_soft is None else np.asarray(y_train_soft, np.float32)
    splits = stratified_kfold(y, n_folds, seed)

    X_ext = y_ext = w_ext = None
    if extra_train is not None:
        X_ext = np.asarray(extra_train[0], np.float32)
        y_ext = np.asarray(extra_train[1])
        w_ext = (np.asarray(extra_train[2], np.float32)
                 if len(extra_train) > 2 and extra_train[2] is not None
                 else np.ones(len(y_ext), np.float32))
    n_ext = 0 if X_ext is None else len(X_ext)
    X_all = X_parent if X_ext is None else np.vstack([X_parent, X_ext])

    def fold_spw(yf):
        if not use_scale_pos_weight:
            return 1.0
        return float((yf == 0).sum() / max((yf == 1).sum(), 1))

    def fold(k, tr, va):
        """A fold's training rows (the objective's targets, soft when
        given; the hard labels only count for scale_pos_weight)."""
        Xf, yh = None, y[tr]
        yf = yh if y_soft is None else y_soft[tr]
        wf = None if sample_weight is None else sample_weight[tr]
        if train_transform is not None:
            Xf, yf, wf = train_transform(X_parent[tr], np.asarray(yf, np.float32), wf, k)
            yh = (np.asarray(yf) >= 0.5).astype(y.dtype)
        if X_ext is not None:
            if Xf is not None:
                Xf = np.vstack([np.asarray(Xf, np.float32), X_ext])
            yf = np.concatenate([yf, y_ext])
            yh = np.concatenate([yh, y_ext])
            wf = np.concatenate([np.ones(len(tr), np.float32) if wf is None else wf, w_ext])
        f = {"y": yf, "w": wf, "y_val": y[va] if y_soft is None else y_soft[va],
             "spw": fold_spw(yh), "seed": params.seed}
        if train_transform is not None:
            f.update(X=Xf, X_val=X_parent[va])
        else:
            f.update(X_parent=X_all, va_idx=va,
                     tr_idx=tr if X_ext is None else np.concatenate(
                         [tr, len(y) + np.arange(n_ext)]))
        return f

    folds = [fold(k, tr, va) for k, (tr, va) in enumerate(splits)]
    models = _fit_folds(
        folds, params, mesh, dev, objective=objective,
        early_stopping_rounds=early_stopping_rounds,
        pad_rows_to=max(len(f["y"]) for f in folds),
        pad_val_rows_to=max(len(va) for _, va in splits))

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
