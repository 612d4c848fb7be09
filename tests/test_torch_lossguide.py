"""Port vs JAX package: leaf-wise (``grow_policy="lossguide"``) GBDT
training and prediction on the CPU.

Fixtures are those of tests/test_lossguide.py (8 columns, a NaN column,
an interaction term; the XOR chain), at a few dozen rounds. The port's
forests must equal the JAX package's: ``feature``, ``split_bin``,
``default_left``, ``is_leaf``, ``left``, ``right`` and ``best_iteration``
identical, leaf values within rtol 2e-4 / atol 2e-5 (the bars of
tests/test_lossguide.py's sharded-vs-single check), validation margins
within 1e-5. The leaf-wise histograms go through the segment histogram
K3's plain version (``hist_cuda.build_seg_histograms`` on a CPU tensor),
which adds in the JAX package's ``segment_sum`` order; the node totals and
split search are the depthwise fit's, in XLA:CPU's order
(``trees/xla_cpu.py``), so exact-arithmetic ties fall the same way.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.trees import gbdt as J
from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.train.cv import stratified_kfold
from mallorn_tpu_torch.trees import gbdt as T

torch.set_num_threads(2)

ARRAYS = ("feature", "split_bin", "default_left", "is_leaf", "left", "right")


def _make_data(n=500, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logit = 1.5 * X[:, 0] - 2.0 * X[:, 1] + X[:, 2] * X[:, 3]
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    X[rng.uniform(size=n) < 0.1, 4] = np.nan
    return X, y


def _chain(n=1000, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0) ^ (X[:, 2] > 0)).astype(np.float32)
    return X, y


def _assert_same_forest(jm, tm):
    assert isinstance(tm.forest, T.LGForest)
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(tm.forest, name).numpy(),
                                      np.asarray(getattr(jm.forest, name)), err_msg=name)
    assert tm.best_iteration == jm.best_iteration
    np.testing.assert_allclose(tm.forest.leaf_value.numpy(), np.asarray(jm.forest.leaf_value),
                               rtol=2e-4, atol=2e-5)


CASES = {
    # NaNs, subsample and colsample, early stopping: v114d's shape
    "leaves8_sampled": (lambda: _make_data(600, 8, 3),
                        dict(n_rounds=30, max_depth=5, max_leaves=8, learning_rate=0.2,
                             subsample=0.8, colsample_bytree=0.8, min_child_weight=3.0)),
    "leaves31": (lambda: _make_data(600, 8, 2),
                 dict(n_rounds=8, max_depth=12, max_leaves=31, learning_rate=0.2,
                      subsample=0.9, colsample_bytree=0.9, min_child_weight=1.0)),
    "deep_chain": (_chain, dict(n_rounds=8, max_depth=8, max_leaves=15, learning_rate=0.3,
                                subsample=1.0, colsample_bytree=1.0, min_child_weight=1.0)),
    # BASELINE_LGBM_PARAMS' regularisation: no L1 / L2 (empty nodes divide
    # 0 by 0), min_child_weight 1e-3, 31 leaves under a depth cap of 6
    "baseline_lgbm": (lambda: _make_data(600, 8, 5),
                      dict(n_rounds=10, max_depth=6, max_leaves=31, learning_rate=0.05,
                           subsample=0.8, colsample_bytree=0.8, min_child_weight=1e-3,
                           reg_alpha=0.0, reg_lambda=0.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_gbdt_lossguide_matches_jax(case):
    make, kw = CASES[case]
    X, y = make()
    n_tr = int(0.75 * len(X))
    Xt, yt, Xv, yv = X[:n_tr], y[:n_tr], X[n_tr:], y[n_tr:]
    spw = float((yt == 0).sum() / (yt == 1).sum())
    jm = J.train_gbdt(Xt, yt, J.GBDTParams(grow_policy="lossguide", **kw),
                      scale_pos_weight=spw, X_val=Xv, y_val=yv, early_stopping_rounds=5)
    tm = T.train_gbdt(Xt, yt, T.GBDTParams(grow_policy="lossguide", **kw),
                      scale_pos_weight=spw, X_val=Xv, y_val=yv, early_stopping_rounds=5,
                      device="cpu")
    _assert_same_forest(jm, tm)
    np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)
    np.testing.assert_allclose(tm.eval_history, np.asarray(jm.eval_history), rtol=1e-5)
    np.testing.assert_allclose(tm.importance_gain, np.asarray(jm.importance_gain),
                               rtol=1e-4, atol=1e-4)
    # prediction on LGForests: one model, and the same model as 2 "folds"
    want = np.asarray(J.predict_margin(jm, Xv))
    got = T.predict_margin_models([tm], torch.from_numpy(Xv))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    got2 = T.predict_margin_models([tm, tm], [torch.from_numpy(Xv), torch.from_numpy(Xt)])
    np.testing.assert_allclose(got2[0, :len(Xv)].numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got2[1].numpy(), np.asarray(J.predict_margin(jm, Xt)),
                               atol=1e-5)


def test_train_gbdt_folds_lossguide_matches_jax_lanes():
    """3 lanes of one fixed fold split, each with its own seed (the kaggle
    ensemble's seed x fold lanes), as one batched fit."""
    X, y = _make_data(480, 8, 11)
    splits = stratified_kfold(y, 3, 42)
    lanes = []
    for k, (tr, va) in enumerate(splits):
        lanes.append({"X": X[tr], "y": y[tr], "w": np.linspace(0.5, 2.0, len(tr)),
                      "X_val": X[va], "y_val": y[va], "spw": 1.7, "seed": (42, 123, 456)[k],
                      "X_parent": X, "tr_idx": tr, "va_idx": va})
    kw = dict(n_rounds=25, max_depth=5, max_leaves=8, learning_rate=0.2, subsample=0.659,
              colsample_bytree=0.591, min_child_weight=3.0, reg_alpha=1.524, reg_lambda=2.72,
              grow_policy="lossguide")
    jms = J.train_gbdt_folds(lanes, J.GBDTParams(**kw), early_stopping_rounds=5)
    tms = T.train_gbdt_folds(lanes, T.GBDTParams(**kw), early_stopping_rounds=5, device="cpu")
    for jm, tm in zip(jms, tms):
        _assert_same_forest(jm, tm)
        np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)
    want = np.asarray(J.predict_margin_folds(jms, [X[va] for _, va in splits]))
    got = T.predict_margin_models(tms, [torch.from_numpy(X[va]) for _, va in splits])
    for k, (_, va) in enumerate(splits):
        np.testing.assert_allclose(got[k, :len(va)].numpy(), want[k, :len(va)], atol=1e-5)


def test_full_leaf_budget_equals_depthwise():
    """max_leaves = 2^D with depth cap D makes the depthwise tree's
    node-local decisions: the same margins (tests/test_lossguide.py:23)."""
    X, y = _make_data(400, 6, seed=1)
    common = dict(n_rounds=10, learning_rate=0.1, subsample=1.0, colsample_bytree=1.0,
                  min_child_weight=1.0, reg_alpha=0.1, reg_lambda=1.0, n_bins=64, max_depth=3)
    dw = T.train_gbdt(X, y, T.GBDTParams(**common), device="cpu")
    lg = T.train_gbdt(X, y, T.GBDTParams(grow_policy="lossguide", max_leaves=8, **common),
                      device="cpu")
    a = T.predict_margin_models([dw], torch.from_numpy(X)).numpy()
    b = T.predict_margin_models([lg], torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_leaf_budget_and_kernel_counts():
    """At most max_leaves leaves with values and max_leaves - 1 splits per
    tree; the seg-hist wrapper runs max_leaves times per round (the root and
    one pair per split step), on the CPU through its plain version, which
    counts no launch."""
    X, y = _make_data(300, 8, seed=2)
    p = T.GBDTParams(n_rounds=5, max_depth=12, grow_policy="lossguide", max_leaves=5,
                     learning_rate=0.2, subsample=1.0, colsample_bytree=1.0,
                     min_child_weight=1.0)
    calls = []

    def counting(*a):
        calls.append(a[-1])
        return hist_cuda.build_seg_histograms(*a)

    hist_cuda.reset_launches()
    m = T.train_gbdt(X, y, p, device="cpu", seg_hist_fn=counting)
    assert hist_cuda.seg_launches == 0
    assert calls == [257, 514, 514, 514, 514] * 5
    lv, is_leaf = m.forest.leaf_value.numpy(), m.forest.is_leaf.numpy()
    assert ((lv != 0).sum(axis=1) <= 5).all() and ((~is_leaf).sum(axis=1) <= 4).all()


def test_unknown_grow_policy_raises():
    X, y = _make_data(64, 8)
    with pytest.raises(ValueError, match="grow_policy"):
        T.train_gbdt(X, y, T.GBDTParams(n_rounds=2, grow_policy="leafwise"), device="cpu")
    with pytest.raises(ValueError, match="num_class"):  # multiclass grows depthwise only
        T.train_gbdt(X, y, T.GBDTParams(n_rounds=2, grow_policy="lossguide", num_class=2),
                     device="cpu")
