"""Port vs JAX package: ``train/oversample.py``, the HPO sampler of
``train/hpo.py`` and the depth HPO's space reaches.

- SMOTE and ADASYN: the same rows as the JAX package's, exactly (the same
  numpy code and ``default_rng`` draws), with NaNs in the matrix, at
  several ratios; no new rows where the minority already reaches the
  ratio or has fewer than 2 rows.
- HPO: ``random_search`` and ``tpe_search`` with a fake ``train_cv``
  replaced in both packages' ``hpo`` modules (as tests/test_ote_tpe.py
  does for the JAX package): 28 trials each, the configs and the
  best-first trial order identical.
- Depth 8 (the top of ``DEFAULT_SPACE["max_depth"]``): a CPU fit of the
  port, with and without histogram subtraction, builds the JAX package's
  default-path forest bit for bit (the fixtures and bars of
  tests/test_torch_gbdt_train.py at max_depth 8); on the card its last
  level is K1's 64-node (subtracted) or 128-node launch.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.train import hpo as jhpo
from mallorn_tpu.train import oversample as jover
from mallorn_tpu.trees import gbdt as J
from mallorn_tpu_torch.train import hpo as thpo
from mallorn_tpu_torch.train import oversample as tover
from mallorn_tpu_torch.trees import gbdt as T
from test_torch_gbdt_train import COMMON, ES, _assert_same_forest, _fixture

torch.set_num_threads(2)


def _imbalanced(n=300, f=9, seed=0, pos=0.08):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < pos).astype(np.int64)
    X = rng.normal(size=(n, f)) + 0.7 * y[:, None]
    X[rng.random(X.shape) < 0.1] = np.nan
    X[:, 3] = 1.0  # a constant column (std 0)
    return X.astype(np.float32), y


@pytest.mark.parametrize("fn", ["smote", "adasyn"])
@pytest.mark.parametrize("ratio,k,seed", [(0.5, 5, 42), (1.0, 3, 7), (0.3, 8, 1)])
def test_oversampling_matches_jax(fn, ratio, k, seed):
    X, y = _imbalanced(seed=seed)
    Xg, yg = getattr(tover, fn)(X, y, k=k, ratio=ratio, seed=seed)
    Xw, yw = getattr(jover, fn)(X, y, k=k, ratio=ratio, seed=seed)
    assert Xg.dtype == Xw.dtype and yg.dtype == yw.dtype
    np.testing.assert_array_equal(Xg, Xw)
    np.testing.assert_array_equal(yg, yw)
    assert len(yg) > len(y) and (yg[len(y):] == 1).all()
    np.testing.assert_array_equal(Xg[:len(y)], X)


@pytest.mark.parametrize("fn", ["smote", "adasyn"])
def test_oversampling_leaves_enough_or_too_few_minority_rows(fn):
    X, y = _imbalanced(seed=3)
    for yy in (np.ones_like(y), np.r_[1, np.zeros(len(y) - 1, y.dtype)]):
        Xg, yg = getattr(tover, fn)(X, yy, ratio=0.5)
        assert Xg is X and yg is yy


SPACE_KEYS = tuple(thpo.DEFAULT_SPACE)


def _fake_cv(X, y, X_test, params, **kwargs):
    """A deterministic stand-in for train_cv: F1 peaks at depth 6 and
    learning rate 0.05, with a little of every other dimension."""
    class R:
        pass

    r = R()
    r.best_f1 = float(0.9 - 0.01 * (params.max_depth - 6) ** 2
                      - 0.05 * (np.log(params.learning_rate) - np.log(0.05)) ** 2
                      - 0.02 * abs(params.subsample - 0.85) - 0.01 * params.reg_alpha
                      + 0.001 * params.min_child_weight)
    r.best_threshold = 0.05 + 0.01 * params.max_depth
    return r


def _configs(trials):
    return [tuple(getattr(t.params, k) for k in SPACE_KEYS) + (t.oof_f1, t.threshold)
            for t in trials]


@pytest.mark.parametrize("search", ["random_search", "tpe_search"])
@pytest.mark.parametrize("seed", [42, 5])
def test_hpo_samples_the_jax_packages_configs(monkeypatch, search, seed):
    monkeypatch.setattr(jhpo, "train_cv", _fake_cv)
    monkeypatch.setattr(thpo, "train_cv", _fake_cv)
    X, y = np.zeros((10, 2), np.float32), np.zeros(10)
    kw = dict(n_trials=28, seed=seed, n_rounds=123)
    got = getattr(thpo, search)(X, y, device="cpu", **kw)
    want = getattr(jhpo, search)(X, y, **kw)
    assert len(got) == len(want) == 28
    assert _configs(got) == _configs(want)
    assert all(t.params.n_rounds == 123 for t in got)
    depths = {t.params.max_depth for t in got}
    assert depths <= set(range(3, 9))


@pytest.mark.parametrize("subtract", [False, True])
@pytest.mark.parametrize("seed", [3, 5])
def test_depth_8_fit_matches_jax(seed, subtract):
    X, y, Xv, yv = _fixture(seed, n=512)
    common = dict(COMMON, n_rounds=12, max_depth=8)
    spw = float((y == 0).sum() / (y == 1).sum())
    jm = J.train_gbdt(X, y, J.GBDTParams(**common), scale_pos_weight=spw,
                      X_val=Xv, y_val=yv, early_stopping_rounds=ES)
    tm = T.train_gbdt(X, y, T.GBDTParams(**common, hist_subtract=subtract),
                      scale_pos_weight=spw, X_val=Xv, y_val=yv,
                      early_stopping_rounds=ES, device="cpu")
    _assert_same_forest(jm, tm)
    # the trees reach depth 8: some split sits on the last internal level
    internal = ~tm.forest.is_leaf & (tm.forest.split_bin >= 0)
    assert bool(internal[:, 2 ** 7 - 1:].any())
    np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)
