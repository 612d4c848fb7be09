"""Port vs JAX package: symmetric (``grow_policy="symmetric"``, CatBoost's
oblivious trees) GBDT training on the CPU.

Fixtures: the seed-11 fixture of
tests/test_hist_pallas.py::test_hist_subtraction_symmetric_parity (256 x 8,
depth 4, 8 rounds), and the 384 (+128 validation) x 12 fixture of
tests/test_torch_gbdt_train.py (15% NaN, subsample = colsample = 0.8,
scale_pos_weight, early stopping), as one fit and as 5 batched folds.

The bars are tests/test_torch_gbdt_train.py's: ``feature``, ``split_bin``,
``default_left``, ``is_leaf`` and ``best_iteration`` identical; leaf values
within rtol 2e-4 / atol 2e-5; validation margins within 1e-5. The port
runs with ``hist_subtract=False`` against the JAX package's default CPU
path (which never subtracts), and with subtraction against its binlane
path (K1 in interpret mode, with subtraction), on the seed-11 fixture
where the JAX package's own two paths agree. The level's gain is the sum
of its nodes' positive gains, added in node order as XLA:CPU adds them
(``xla_cpu.level_sum``), so exact-arithmetic ties fall the same way.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.trees import gbdt as J
from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.train.cv import stratified_kfold
from mallorn_tpu_torch.trees import gbdt as T

torch.set_num_threads(2)

ARRAYS = ("feature", "split_bin", "default_left", "is_leaf")
SYM = dict(n_rounds=8, max_depth=4, learning_rate=0.3, subsample=1.0,
           colsample_bytree=1.0, grow_policy="symmetric")
COMMON = dict(n_rounds=30, max_depth=4, learning_rate=0.3, subsample=0.8,
              colsample_bytree=0.8, grow_policy="symmetric")
ES = 5


def _seed11():
    rng = np.random.default_rng(11)
    n, f = 256, 8
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (0.8 * X[:, 1] + 0.2 * rng.normal(size=n) > 0.0).astype(np.float32)
    return X, y


def _fixture(seed, n=384, nv=128, f=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + nv, f)).astype(np.float32)
    y = (0.7 * X[:, 2] - 0.4 * X[:, 5] + 0.4 * rng.normal(size=n + nv) > 0.3).astype(np.float32)
    X[rng.random((n + nv, f)) < 0.15] = np.nan
    return X[:n], y[:n], X[n:], y[n:]


def _assert_same_forest(jm, tm):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(tm.forest, name).numpy(),
                                      np.asarray(getattr(jm.forest, name)), err_msg=name)
    assert tm.best_iteration == jm.best_iteration
    np.testing.assert_allclose(tm.forest.leaf_value.numpy(), np.asarray(jm.forest.leaf_value),
                               rtol=2e-4, atol=2e-5)
    if jm.eval_history is not None:
        np.testing.assert_allclose(tm.eval_history, np.asarray(jm.eval_history), rtol=1e-5)


@pytest.mark.parametrize("binlane", [False, True])
def test_symmetric_seed11_matches_jax(binlane):
    X, y = _seed11()
    jm = J.train_gbdt(X, y, J.GBDTParams(**SYM, use_binlane_hist=binlane,
                                         hist_subtract=binlane))
    tm = T.train_gbdt(X, y, T.GBDTParams(**SYM, hist_subtract=binlane), device="cpu")
    _assert_same_forest(jm, tm)
    assert (~tm.forest.is_leaf).any()


@pytest.mark.parametrize("subtract", [False, True])
@pytest.mark.parametrize("seed", [3, 5])
def test_symmetric_fit_matches_jax_default_path(seed, subtract):
    X, y, Xv, yv = _fixture(seed)
    spw = float((y == 0).sum() / (y == 1).sum())
    jm = J.train_gbdt(X, y, J.GBDTParams(**COMMON), scale_pos_weight=spw,
                      X_val=Xv, y_val=yv, early_stopping_rounds=ES)
    tm = T.train_gbdt(X, y, T.GBDTParams(**COMMON, hist_subtract=subtract),
                      scale_pos_weight=spw, X_val=Xv, y_val=yv,
                      early_stopping_rounds=ES, device="cpu")
    _assert_same_forest(jm, tm)
    np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)
    np.testing.assert_allclose(tm.importance_gain, np.asarray(jm.importance_gain),
                               rtol=1e-4, atol=1e-4)
    got = T.predict_margin_models([tm], torch.from_numpy(Xv))[0].numpy()
    np.testing.assert_allclose(got, np.asarray(J.predict_margin(jm, Xv)), atol=1e-5)


def test_symmetric_folds_match_jax():
    """5 folds, each with its own seed, as one batched fit."""
    X, y, _, _ = _fixture(11, n=480, nv=0)
    folds = [{"X": X[tr], "y": y[tr], "X_val": X[va], "y_val": y[va],
              "spw": float((y[tr] == 0).sum() / (y[tr] == 1).sum()), "seed": 42 + k,
              "X_parent": X, "tr_idx": tr, "va_idx": va}
             for k, (tr, va) in enumerate(stratified_kfold(y, 5, 42))]
    jms = J.train_gbdt_folds(folds, J.GBDTParams(**COMMON), early_stopping_rounds=ES,
                             pad_rows_to=384)
    tms = T.train_gbdt_folds(folds, T.GBDTParams(**COMMON, hist_subtract=False),
                             early_stopping_rounds=ES, pad_rows_to=384, device="cpu")
    for jm, tm in zip(jms, tms):
        _assert_same_forest(jm, tm)
        np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)


def test_symmetric_trees_are_oblivious_and_build_one_histogram_per_level():
    """Every split node of a level carries the level's one (feature, bin,
    default direction); a level is all split or all leaf; the fit builds
    one level histogram per level (depth per round)."""
    X, y, _, _ = _fixture(5)
    calls = []

    def counting(*a):
        calls.append(a[3])
        return hist_cuda.build_histograms(*a)

    p = T.GBDTParams(**{**COMMON, "n_rounds": 6, "max_depth": 5})
    m = T.train_gbdt(X, y, p, device="cpu", hist_fn=counting)
    assert calls == [1, 1, 2, 4, 8] * 6  # subtraction: left children from level 1 on
    f = m.forest
    for r in range(6):
        for d in range(5):
            ids = slice(2 ** d - 1, 2 ** (d + 1) - 1)
            leaf = f.is_leaf[r, ids]
            assert bool(leaf.all()) or not bool(leaf.any())
            if not bool(leaf.any()):
                for a in (f.feature, f.split_bin, f.default_left):
                    assert len(torch.unique(a[r, ids])) == 1
    assert (~f.is_leaf[:, :1]).all()
