"""Port vs JAX package: the squarederror objective and the rmse metric,
``train_cv``'s three hooks (``extra_train``, ``y_train_soft``,
``train_transform``), the soft-label runners v102 (label smoothing), v108
(distillation) and v97 (soft pseudo-labels), v42 (hard pseudo-labels) and
v106 (MixUp), on the CPU.

Fixtures are tests/test_soft_labels.py's (rows of 8 normal columns, a
NaN column, ~15% positives), at depth 3 and a few dozen rounds. The JAX
package's CPU path builds every histogram directly, so the port runs with
``hist_subtract=False``, the same arithmetic. Bars (tests/test_torch_cv.py,
test_torch_kaggle.py): forests and best iterations equal, metric
histories within rtol 1e-5; OOF and test outputs within atol 1e-5; F1s
and thresholds equal; importance within rtol 1e-4 / atol 1e-3;
``temperature_scale`` and ``mixup_matrix`` bit for bit.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.train import cv as JC
from mallorn_tpu.train import pipelines as JP
from mallorn_tpu.trees import gbdt as JG
from mallorn_tpu.trees import objectives as JO
from mallorn_tpu_torch.train import cv as TC
from mallorn_tpu_torch.train import pipelines as TP
from mallorn_tpu_torch.trees import gbdt as TG
from mallorn_tpu_torch.trees import objectives as TO

torch.set_num_threads(2)

SOFT = dict(n_rounds=30, max_depth=3, learning_rate=0.1)
HARD = dict(n_rounds=30, max_depth=3, learning_rate=0.15)


def _binary_data(n=400, f=8, seed=0, pos_frac=0.15):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logit = 2.0 * X[:, 0] - 1.5 * X[:, 1] + X[:, 2]
    thresh = np.quantile(logit, 1 - pos_frac)
    y = (logit + rng.normal(scale=0.4, size=n) > thresh).astype(np.float32)
    X[rng.uniform(size=n) < 0.1, 3] = np.nan
    return X, y


def _params(pkg, **kw):
    """SOFT_LABEL_PARAMS of ``pkg``, shortened (the port without subtraction)."""
    p = pkg.SOFT_LABEL_PARAMS._replace(**kw)
    return p._replace(hist_subtract=False) if pkg is TP else p


def _assert_same_cv(got, want):
    assert [m.best_iteration for m in got.models] == [m.best_iteration for m in want.models]
    np.testing.assert_allclose(got.oof_preds, want.oof_preds, rtol=0, atol=1e-5)
    if want.test_preds is not None:
        np.testing.assert_allclose(got.test_preds, want.test_preds, rtol=0, atol=1e-5)
    assert (got.best_f1, got.best_threshold) == (want.best_f1, want.best_threshold)
    assert got.fold_f1s == want.fold_f1s
    np.testing.assert_allclose(got.importance_gain, np.asarray(want.importance_gain),
                               rtol=1e-4, atol=1e-3)


def test_constants_match_the_jax_package():
    for k, v in TP.SOFT_LABEL_PARAMS._asdict().items():
        assert getattr(JP.SOFT_LABEL_PARAMS, k) == v, k
    assert TP.V102_EPSILONS == JP.V102_EPSILONS


@pytest.mark.parametrize("case", ["single", "sampled"])
def test_squarederror_rmse_fit_matches_jax(case):
    """A squarederror fit early-stopped on rmse at base_score 0.5: the
    same forest, best iteration, metric history and validation margins."""
    X, y = _binary_data(400, 8, seed=1 if case == "single" else 5)
    ys = np.where(y == 1, 0.9, 0.1).astype(np.float32)
    kw = dict(SOFT, subsample=0.8, colsample_bytree=0.8)
    if case == "single":
        kw.update(subsample=1.0, colsample_bytree=1.0, reg_alpha=0.0)
    jm = JG.train_gbdt(X[:300], ys[:300], _params(JP, **kw), objective=JO.squarederror,
                       X_val=X[300:], y_val=ys[300:], early_stopping_rounds=5)
    tm = TG.train_gbdt(X[:300], ys[:300], _params(TP, **kw), objective=TO.squarederror,
                       X_val=X[300:], y_val=ys[300:], early_stopping_rounds=5, device="cpu")
    for name in ("feature", "split_bin", "default_left", "is_leaf"):
        np.testing.assert_array_equal(getattr(tm.forest, name).numpy(),
                                      np.asarray(getattr(jm.forest, name)), err_msg=name)
    np.testing.assert_allclose(tm.forest.leaf_value.numpy(), np.asarray(jm.forest.leaf_value),
                               rtol=2e-4, atol=2e-5)
    assert tm.best_iteration == jm.best_iteration
    np.testing.assert_allclose(tm.eval_history, np.asarray(jm.eval_history), rtol=1e-5)
    np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)
    # the margins start at base_score: a fit's prediction is 0.5 + its trees
    got = TG.predict_margin_models([tm], torch.from_numpy(X[300:]))[0].numpy()
    np.testing.assert_allclose(got, np.asarray(JG.predict_margin(jm, X[300:])), atol=1e-5)


@pytest.mark.parametrize("bad", [dict(eval_metric="auc"), dict(eval_metric="mlogloss"),
                                 dict(grow_policy="oblivious")])
def test_unsupported_metric_and_policies_raise(bad):
    """An unknown metric or policy raises, as does mlogloss on a binary
    fit; so does multiclass with a leaf-wise, symmetric or DART fit."""
    X, y = _binary_data(60, 4, seed=2)
    with pytest.raises(ValueError):
        TG.train_gbdt(X, y, TG.GBDTParams(n_rounds=2, max_depth=2, **bad), X_val=X, y_val=y,
                      device="cpu")
    for mc in (dict(grow_policy="lossguide"), dict(grow_policy="symmetric"),
               dict(dart_rate=0.15)):
        with pytest.raises(ValueError, match="num_class"):
            TG.train_gbdt(X, y, TG.GBDTParams(n_rounds=2, max_depth=2, num_class=2, **mc),
                          device="cpu")


def _hook(name, X, y, Xte):
    if name == "y_train_soft":
        return dict(y_train_soft=np.where(y == 1, 0.85, 0.05).astype(np.float32))
    if name == "extra_train":
        rng = np.random.default_rng(9)
        return dict(extra_train=(Xte[:60], rng.uniform(0, 1, 60).astype(np.float32),
                                 rng.uniform(0.5, 2.0, 60).astype(np.float32)))
    return dict(train_transform=lambda Xf, yf, wf, k: JP.mixup_matrix(Xf, yf, wf, 0.4, 7 + k))


@pytest.mark.parametrize("hook", ["extra_train", "y_train_soft", "train_transform"])
def test_train_cv_hook_matches_jax(hook):
    X, y = _binary_data(400, 8, seed=3)
    Xte, _ = _binary_data(150, 8, seed=4)
    w = np.linspace(0.5, 2.0, len(y))
    kw = dict(sample_weight=w, use_scale_pos_weight=True, early_stopping_rounds=5,
              **_hook(hook, X, y, Xte))
    if hook != "extra_train":
        # the soft hooks regress on raw margins, as their runners do
        want = JC.train_cv(X, y, Xte, _params(JP, **SOFT), objective=JO.squarederror, **kw)
        got = TC.train_cv(X, y, Xte, _params(TP, **SOFT), objective=TO.squarederror,
                          device="cpu", **kw)
    else:
        want = JC.train_cv(X, y, Xte, JG.GBDTParams(**HARD), **kw)
        got = TC.train_cv(X, y, Xte, TG.GBDTParams(**HARD, hist_subtract=False),
                          device="cpu", **kw)
    _assert_same_cv(got, want)
    for jm, tm in zip(want.models, got.models):
        np.testing.assert_allclose(tm.eval_history, np.asarray(jm.eval_history), rtol=1e-5)


def test_soft_targets_reach_the_metric_not_the_sweep():
    """y_train_soft feeds the objective and the early-stopping metric; the
    folds and the sweep stay on the hard labels; raw margins come back."""
    X, y = _binary_data(300, 6, seed=6)
    soft = np.where(y == 1, 0.8, 0.2).astype(np.float32)
    cv = TC.train_cv(X, y, None, _params(TP, **SOFT), objective=TO.squarederror,
                     y_train_soft=soft, early_stopping_rounds=5, device="cpu")
    folds = TC.stratified_kfold(y, 5, 42)
    for m, (_, va) in zip(cv.models, folds):
        rmse = np.sqrt(np.mean((m.val_margin[:len(va)] - soft[va]) ** 2))
        assert rmse == pytest.approx(m.eval_history[m.best_iteration], rel=1e-5)
    assert cv.best_f1 == TC.threshold_sweep(y, cv.oof_preds)[0]
    assert cv.oof_preds.min() < 0.2 < cv.oof_preds.max() < 1.0  # margins, no sigmoid


RUNNERS = {
    "v102": lambda pkg, X, y, Xte, p, w, teacher, **dev: pkg.run_label_smoothing(
        X, y, Xte, epsilon=0.05, params=p, sample_weight=w, **dev),
    "v108": lambda pkg, X, y, Xte, p, w, teacher, **dev: pkg.run_distillation(
        X, y, teacher, Xte, alpha=0.5, temperature=2.0, params=p, sample_weight=w, **dev),
    "v97": lambda pkg, X, y, Xte, p, w, teacher, **dev: pkg.run_soft_pseudo(
        X, y, Xte, teacher, threshold=0.8, params=p, sample_weight=w, **dev),
    "v97d": lambda pkg, X, y, Xte, p, w, teacher, **dev: pkg.run_soft_pseudo(
        X, y, Xte, teacher, threshold=0.8, use_actual_probs=True, params=p, **dev),
    "v42": lambda pkg, X, y, Xte, p, w, teacher, **dev: pkg.run_pseudo_label(
        X, y, Xte, teacher, params=(JG.GBDTParams(**HARD) if pkg is JP else
                                    TG.GBDTParams(**HARD, hist_subtract=False)),
        confidence=0.95, sample_weight=w, **dev),
}


@pytest.mark.parametrize("runner", sorted(RUNNERS))
def test_soft_label_runner_matches_jax(runner):
    X, y = _binary_data(360, 8, seed=7)
    Xte, _ = _binary_data(200, 8, seed=8)
    w = np.linspace(0.6, 1.8, len(y))
    # a teacher: squashed scores of the informative columns, some of them
    # confident (both the OOF vector of v108 and the test vector of v97/v42)
    teacher_te = 1.0 / (1.0 + np.exp(-(3.0 * Xte[:, 0] - 2.0 * Xte[:, 1] - 3.0)))
    teacher = (teacher_te if runner != "v108" else
               1.0 / (1.0 + np.exp(-(3.0 * X[:, 0] - 2.0 * X[:, 1] - 3.0))))
    fn = RUNNERS[runner]
    want = fn(JP, X, y, Xte, _params(JP, **SOFT), w, teacher)
    got = fn(TP, X, y, Xte, _params(TP, **SOFT), w, teacher, device="cpu")
    _assert_same_cv(got, want)


def test_temperature_scale_and_mixup_matrix_bit_for_bit():
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 1, 500)
    p[:3] = (0.0, 1.0, 0.5)
    for t in (0.5, 1.0, 2.0, 3.7):
        np.testing.assert_array_equal(TP.temperature_scale(p, t), JP.temperature_scale(p, t))
    X = rng.normal(size=(64, 5)).astype(np.float32)
    X[0, 0] = np.nan
    y = (rng.uniform(size=64) > 0.8).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=64).astype(np.float32)
    for alpha, seed, weights in ((0.2, 42, w), (1.0, 7, w), (0.4, 3, None)):
        got = TP.mixup_matrix(X, y, weights, alpha, seed)
        want = JP.mixup_matrix(X, y, weights, alpha, seed)
        for g, v in zip(got, want):
            if v is None:
                assert g is None
            else:
                assert g.dtype == v.dtype
                np.testing.assert_array_equal(g, v)


def test_run_mixup_matches_jax():
    X, y = _binary_data(300, 8, seed=9)
    Xte, _ = _binary_data(100, 8, seed=10)
    w = np.linspace(0.5, 1.5, len(y))
    kw = dict(alpha=0.3, seeds=(42, 123), n_folds=3, sample_weight=w)
    want = JP.run_mixup(X, y, Xte, params=_params(JP, **SOFT), **kw)
    got = TP.run_mixup(X, y, Xte, params=_params(TP, **SOFT), device="cpu", **kw)
    np.testing.assert_allclose(got.oof_preds, want.oof_preds, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.test_preds, want.test_preds, rtol=0, atol=1e-5)
    assert (got.best_f1, got.best_threshold) == (want.best_f1, want.best_threshold)
    assert got.fold_f1s == want.fold_f1s and len(got.models) == len(want.models) == 6
    assert [m.best_iteration for m in got.models] == [m.best_iteration for m in want.models]
    np.testing.assert_allclose(got.importance_gain, np.asarray(want.importance_gain),
                               rtol=1e-4, atol=1e-3)
    assert 0.0 <= got.oof_preds.min() and got.oof_preds.max() <= 1.0
