"""Port vs JAX package (and the scikit-learn / pandas calls it makes):
folds, AUC, threshold sweep, CV, adversarial weights, feature selection
and the submission file, on the CPU.

Bars: folds, the threshold sweep, the selection lists and the shift
decision exactly equal; AUC within 1e-12 (the same rank statistic summed
in another order); OOF and test probabilities and the adversarial
weights within 1e-5. The JAX package's CPU path builds every tree level's
histograms directly, so the port's fits here run with
``hist_subtract=False``, the same arithmetic (tests/test_torch_gbdt_train.py
holds the subtracted fit against both JAX paths).
"""

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.metrics import roc_auc_score
from sklearn.model_selection import StratifiedKFold

from mallorn_tpu.io.submission import write_submission as jax_write_submission
from mallorn_tpu.train import adversarial as JA
from mallorn_tpu.train import cv as JC
from mallorn_tpu.train import feature_selection as JS
from mallorn_tpu.trees.gbdt import GBDTParams as JParams
from mallorn_tpu_torch.io.submission import write_submission
from mallorn_tpu_torch.train import adversarial as TA
from mallorn_tpu_torch.train import cv as TC
from mallorn_tpu_torch.train import feature_selection as TS
from mallorn_tpu_torch.trees.gbdt import GBDTParams as TParams

torch.set_num_threads(2)

FIT = dict(n_rounds=80, max_depth=3, learning_rate=0.1)


@pytest.mark.parametrize("n,n_splits,seed,labels", [
    (300, 5, 42, (0, 1)), (3054, 5, 42, (0, 1)), (101, 3, 7, (1, 0)),
    (257, 5, 42, ("tde", "sn", "agn"))])
def test_stratified_folds_equal_sklearn(n, n_splits, seed, labels):
    rng = np.random.default_rng(n)
    y = np.asarray(labels, dtype=object)[rng.choice(len(labels), n, p=np.linspace(1, 2, len(labels)) / np.linspace(1, 2, len(labels)).sum())]
    y = y.astype(type(labels[0]))
    want = list(StratifiedKFold(n_splits, shuffle=True, random_state=seed).split(np.zeros(n), y))
    got = TC.stratified_kfold(y, n_splits, seed)
    assert len(got) == n_splits
    for (tr, va), (wtr, wva) in zip(got, want):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(va, wva)


@pytest.mark.parametrize("decimals", [None, 2, 1])
def test_auc_equals_sklearn_with_ties(decimals):
    rng = np.random.default_rng(3)
    y = rng.random(2000) < 0.3
    s = rng.random(2000) + 0.3 * y
    if decimals is not None:
        s = np.round(s, decimals)  # many tied scores
    assert abs(TA.roc_auc(y, s) - roc_auc_score(y, s)) < 1e-12


def test_threshold_sweep_equals_jax():
    rng = np.random.default_rng(4)
    y = rng.random(700) < 0.1
    p = np.clip(rng.random(700) * 0.6 + 0.2 * y, 0, 1)
    for grid in (None, np.linspace(0.05, 0.5, 200), np.linspace(0.05, 0.5, 50)):
        assert TC.threshold_sweep(y, p, grid) == JC.threshold_sweep(y, p, grid)
    assert TC.threshold_sweep(np.zeros(5), np.zeros(5)) == (0.0, 0.5)


def _matrix(seed=0, n=300, nt=120, f=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.random((n, f)) < 0.1] = np.nan
    y = (X[:, 0] + 0.5 * rng.normal(size=n) > 0.8).astype(int)
    Xt = rng.normal(size=(nt, f)).astype(np.float32)
    return X, y, Xt


def test_train_cv_matches_jax():
    X, y, Xt = _matrix()
    w = np.linspace(0.5, 2.0, len(y))
    cj = JC.train_cv(X, y, Xt, JParams(**FIT), sample_weight=w, early_stopping_rounds=10,
                     threshold_grid=np.linspace(0.05, 0.5, 200))
    ct = TC.train_cv(X, y, Xt, TParams(**FIT, hist_subtract=False), sample_weight=w, early_stopping_rounds=10,
                     threshold_grid=np.linspace(0.05, 0.5, 200), device="cpu")
    assert [m.best_iteration for m in ct.models] == [m.best_iteration for m in cj.models]
    np.testing.assert_allclose(ct.oof_preds, cj.oof_preds, atol=1e-5)
    np.testing.assert_allclose(ct.test_preds, cj.test_preds, atol=1e-5)
    assert (ct.best_f1, ct.best_threshold) == (cj.best_f1, cj.best_threshold)
    assert ct.fold_f1s == cj.fold_f1s
    np.testing.assert_allclose(ct.importance_gain, np.asarray(cj.importance_gain),
                               rtol=1e-4, atol=1e-3)
    assert ct.confusion(y) == cj.confusion(y)


def test_adversarial_validation_matches_jax():
    X, _, Xt = _matrix(1)
    Xt = Xt + 0.3  # an injected shift
    aj = JA.adversarial_validation(X, Xt)
    at = TA.adversarial_validation(X, Xt, TA.ADV_PARAMS._replace(hist_subtract=False),
                                   device="cpu")
    assert at.distribution_shift == aj.distribution_shift
    assert at.distribution_shift  # the shift is found: weights are not uniform
    assert abs(at.auc - aj.auc) < 1e-12
    np.testing.assert_allclose(at.sample_weights, aj.sample_weights, atol=1e-5)
    assert 0.5 <= at.sample_weights.min() and at.sample_weights.max() <= 2.0


def _selection_case():
    rng = np.random.default_rng(2)
    n, f = 400, 60
    X = rng.normal(size=(n, f)) * rng.lognormal(0, 2, f)
    X[:, 10] = 3 * X[:, 3] + 1e-4 * rng.normal(size=n)  # correlated pairs
    X[:, 20] = -X[:, 3]
    X[:, 30] = X[:, 7] + 1e-3 * rng.normal(size=n)
    X[:, 40] = X[:, 30]  # an exact duplicate: |corr| == 1 ties
    X[rng.random((n, f)) < 0.1] = np.nan
    names = [f"feat_{i:02d}" for i in range(f)]
    gains = np.round(rng.random(f) * 10, 0)  # many tied gains
    gains[::7] = 0.0
    return X, names, gains


def test_select_features_equals_jax():
    X, names, gains = _selection_case()
    want = JS.select_features(X, names, gains, top_k=25)
    got = TS.select_features(X, names, gains, top_k=25)
    assert got.selected == want.selected
    assert got.dropped_correlated == want.dropped_correlated
    assert list(got.importance["feature"]) == want.importance["feature"].tolist()
    assert list(got.high_corr_pairs["feature_1"]) == want.high_corr_pairs["feature_1"].tolist()
    assert list(got.high_corr_pairs["feature_2"]) == want.high_corr_pairs["feature_2"].tolist()
    np.testing.assert_allclose(got.high_corr_pairs["correlation"],
                               want.high_corr_pairs["correlation"].to_numpy(), rtol=1e-12)
    np.testing.assert_allclose(TS._pairwise_complete_corr(X), pd.DataFrame(X).corr().to_numpy(),
                               rtol=1e-10, atol=1e-10)


def test_cached_select_features_roundtrip(tmp_path):
    X, names, gains = _selection_case()
    y = np.arange(len(X)) % 2
    calls = []

    def importance():
        calls.append(1)
        return gains

    path = tmp_path / "selection.npz"
    a = TS.cached_select_features(path, X, y, names, importance, 25, key_extra="k")
    b = TS.cached_select_features(path, X, y, names, importance, 25, key_extra="k")
    assert len(calls) == 1 and path.exists()
    assert a.selected == b.selected and a.dropped_correlated == b.dropped_correlated
    TS.cached_select_features(path, X, y, names, importance, 25, key_extra="other")
    assert len(calls) == 2  # another config recomputes
    TS.cached_select_features(None, X, y, names, importance, 25)
    assert len(calls) == 3


def test_submission_file_equals_jax(tmp_path):
    ids = np.array(["obj_1", "obj_22", "obj_3"])
    pred = np.array([1, 0, 1])
    got = write_submission(tmp_path / "port" / "sub.csv", ids, pred).read_text()
    want = jax_write_submission(tmp_path / "jax" / "sub.csv", ids, pred).read_text()
    assert got == want
