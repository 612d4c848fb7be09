"""Adversarial validation: train-vs-test shift detection and sample
reweighting (port of ``mallorn_tpu.train.adversarial``).

Train rows are labelled 0 and test rows 1; a 5-fold depth-3 GBDT gives
out-of-fold p(test-like); an AUC >= 0.55 counts as shift, and the train
rows are then weighted 0.5 + 1.5 p in [0.5, 2.0], else uniformly.
``roc_auc`` is a numpy copy of ``roc_auc_score`` (tied scores share their
average rank), since the machine with the card has no scikit-learn.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mallorn_tpu_torch.train.cv import train_cv
from mallorn_tpu_torch.trees.gbdt import GBDTParams
from mallorn_tpu_torch.utils.device import DeviceLike

# the reference adversarial classifier (adversarial_validation.py:122-132)
ADV_PARAMS = GBDTParams(n_rounds=100, max_depth=3, learning_rate=0.05,
                        subsample=0.8, colsample_bytree=0.8,
                        min_child_weight=1.0, reg_alpha=0.0, reg_lambda=1.0)


@dataclasses.dataclass
class AdversarialResult:
    auc: float
    distribution_shift: bool
    sample_weights: np.ndarray  # [N_train]
    train_adv_preds: np.ndarray  # [N_train] p(test-like)
    importance_gain: np.ndarray
    rounds_run: int = 0  # boosting rounds of the batched adversarial fit


def roc_auc(y: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve of binary labels ``y`` for ``score``: the
    Mann-Whitney statistic with average ranks for ties."""
    y = np.asarray(y).astype(bool)
    s = np.asarray(score, dtype=np.float64)
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes")
    order = np.argsort(s, kind="mergesort")
    s_sorted = s[order]
    first = np.r_[True, s_sorted[1:] != s_sorted[:-1]]
    starts = np.flatnonzero(first)
    ends = np.r_[starts[1:], len(s)]
    avg = (starts + ends + 1) / 2.0  # mean 1-based rank of each tie group
    ranks = np.empty(len(s))
    ranks[order] = np.repeat(avg, ends - starts)
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def adversarial_validation(X_train: np.ndarray, X_test: np.ndarray,
                           params: GBDTParams = ADV_PARAMS, n_folds: int = 5,
                           seed: int = 42, early_stopping_rounds: int = 20,
                           device: DeviceLike = None, mesh=None) -> AdversarialResult:
    """``mesh`` (None: the default mesh): the folds' rows split over its
    ranks (the same trees as on one device)."""
    X = np.vstack([X_train, X_test])
    y = np.concatenate([np.zeros(len(X_train)), np.ones(len(X_test))])
    cv = train_cv(X, y, None, params, use_scale_pos_weight=False, n_folds=n_folds,
                  seed=seed, early_stopping_rounds=early_stopping_rounds,
                  device=device, mesh=mesh)
    auc = roc_auc(y, cv.oof_preds)
    shift = auc >= 0.55  # reweight from "moderate" shift up
    train_preds = cv.oof_preds[: len(X_train)]
    weights = 0.5 + 1.5 * train_preds if shift else np.ones(len(X_train))
    return AdversarialResult(auc=auc, distribution_shift=shift, sample_weights=weights,
                             train_adv_preds=train_preds,
                             importance_gain=cv.importance_gain, rounds_run=cv.rounds_run)
