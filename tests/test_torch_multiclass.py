"""Port vs JAX package: multiclass (``num_class >= 2``, multi:softprob)
training, ``train_cv_multiclass``, ``run_v62`` and ``simplify_spectype``
on the CPU, and the combinations the port refuses.

Fixtures: 384 training rows (+128 validation rows) x 10 columns of 3 or 4
classes (argmax of noisy linear logits; 10% NaN in a column), subsample =
colsample = 0.8, early stopping on mlogloss, depth 3 (3 classes) or 2 (4
classes); ``train_cv_multiclass`` and ``run_v62`` on the 400 x 10 fixture
of the JAX package's tests/test_soft_labels.py, at 25 rounds of depth 2
(the JAX package's compile time grows with classes x levels).

The bars are tests/test_torch_gbdt_train.py's: ``feature``, ``split_bin``,
``default_left``, ``is_leaf`` ([R, C, ...]) and ``best_iteration``
identical; leaf values within rtol 2e-4 / atol 2e-5; validation margins
([C, Nv]) and probabilities within 1e-5. A round's class trees grow from
the softmax taken at the round's start, as extra lanes of one fit; the
softmax takes XLA:CPU's exp (``xla_cpu.exp``) and adds the classes in
order, so the gradients, and the forests, are the JAX package's.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.train import cv as JCV
from mallorn_tpu.train import pipelines as JP
from mallorn_tpu.trees import gbdt as J
from mallorn_tpu_torch.ops import hist_cuda
from mallorn_tpu_torch.train import cv as TCV
from mallorn_tpu_torch.train import pipelines as TP
from mallorn_tpu_torch.trees import gbdt as T

torch.set_num_threads(2)

ARRAYS = ("feature", "split_bin", "default_left", "is_leaf")
COMMON = dict(n_rounds=30, max_depth=3, learning_rate=0.3, subsample=0.8,
              colsample_bytree=0.8)
ES = 5


def _mc_fixture(n_class, seed, n=384, nv=128, f=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + nv, f)).astype(np.float32)
    W = rng.normal(size=(f, n_class))
    y = np.argmax(X @ W + rng.normal(scale=0.7, size=(n + nv, n_class)), axis=1)
    X[rng.uniform(size=n + nv) < 0.1, 2] = np.nan
    y = y.astype(np.float32)
    return X[:n], y[:n], X[n:], y[n:]


def _assert_same_forest(jm, tm):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(tm.forest, name).numpy(),
                                      np.asarray(getattr(jm.forest, name)), err_msg=name)
    assert tm.best_iteration == jm.best_iteration
    np.testing.assert_allclose(tm.forest.leaf_value.numpy(), np.asarray(jm.forest.leaf_value),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tm.eval_history, np.asarray(jm.eval_history), rtol=1e-5)


@pytest.mark.parametrize("n_class,seed,depth", [(3, 9, 3), (4, 13, 2)])
def test_multiclass_train_gbdt_matches_jax(n_class, seed, depth):
    X, y, Xv, yv = _mc_fixture(n_class, seed)
    kw = dict(COMMON, num_class=n_class, max_depth=depth)
    jm = J.train_gbdt(X, y, J.GBDTParams(**kw), X_val=Xv, y_val=yv,
                      early_stopping_rounds=ES)
    calls = []

    def counting(*a):
        calls.append(a[0].shape[0])
        return hist_cuda.build_histograms(*a)

    tm = T.train_gbdt(X, y, T.GBDTParams(**kw, hist_subtract=False), X_val=Xv, y_val=yv,
                      early_stopping_rounds=ES, device="cpu", hist_fn=counting)
    assert tm.forest.feature.shape == (COMMON["n_rounds"], n_class, 2 ** depth - 1)
    _assert_same_forest(jm, tm)
    # every class tree of a round in one histogram call per level
    rounds = int(np.isfinite(tm.eval_history).sum())
    assert calls == [n_class] * (rounds * depth)
    assert tm.val_margin.shape == (n_class, len(yv))
    np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)
    np.testing.assert_allclose(tm.importance_gain, np.asarray(jm.importance_gain),
                               rtol=1e-4, atol=1e-4)
    got = T.predict_proba(tm, Xv).numpy()
    np.testing.assert_allclose(got, np.asarray(J.predict_proba(jm, Xv)), atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    # the fit-tracked margins equal an explicit best-iteration predict
    np.testing.assert_allclose(T.predict_margin_models([tm], torch.from_numpy(Xv))[0].numpy(),
                               tm.val_margin.T, atol=1e-5)


def test_multiclass_folds_equal_single_fits():
    """Folds x classes as lanes of one batched fit (with the port's default
    subtraction, the card's path): each fold's forest, metric history and
    margins are those of its own single fit, bit for bit."""
    X, y, Xv, yv = _mc_fixture(3, 9)
    p = T.GBDTParams(**COMMON, num_class=3)
    halves = [(slice(0, 192), slice(0, 64), 42), (slice(192, 384), slice(64, 128), 7)]
    folds = [{"X": X[a], "y": y[a], "X_val": Xv[b], "y_val": yv[b], "seed": sd}
             for a, b, sd in halves]
    batched = T.train_gbdt_folds(folds, p, early_stopping_rounds=ES, device="cpu")
    for f, tm in zip(folds, batched):
        one = T.train_gbdt(f["X"], f["y"], p._replace(seed=f["seed"]), X_val=f["X_val"],
                           y_val=f["y_val"], early_stopping_rounds=ES, device="cpu")
        for name, a, b in zip(type(one.forest)._fields, one.forest, tm.forest):
            assert torch.equal(a, b), name
        assert one.best_iteration == tm.best_iteration
        np.testing.assert_array_equal(one.eval_history, tm.eval_history)
        np.testing.assert_array_equal(one.val_margin, tm.val_margin)
    assert batched[0].best_iteration != batched[1].best_iteration or not torch.equal(
        batched[0].forest.feature, batched[1].forest.feature)


def _v62_data(n=400):
    """The JAX package's run_v62 fixture (tests/test_soft_labels.py): four
    spectral types driven by the first four columns; TDE is the binary
    target."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(n, 10)).astype(np.float32)
    logits = np.column_stack([2.0 * X[:, 0], 2.0 * X[:, 1], 2.0 * X[:, 2], 2.0 * X[:, 3]]) \
        + rng.normal(scale=0.5, size=(n, 4))
    cls = np.argmax(logits, axis=1)
    spec = np.array(["TDE", "AGN", "SN Ia", "SN II"])[cls]
    return X, spec, (cls == 0).astype(np.float32)


# the multiclass head of both tests below (one compiled JAX fit serves
# both), and run_v62's final binary CV, cut to 25 rounds of depth 2
MC = dict(n_rounds=25, max_depth=2)


def test_train_cv_multiclass_matches_jax():
    X, spec, _ = _v62_data()
    y_mc = np.searchsorted(["AGN", "SN_CC", "SN_Ia", "TDE"], TP.simplify_spectype(spec))
    j_oof, j_test, jms = JCV.train_cv_multiclass(
        X, y_mc, X[:80], JP.V62_MC_PARAMS._replace(**MC, num_class=4))
    t_oof, t_test, tms = TCV.train_cv_multiclass(
        X, y_mc, X[:80], TP.V62_MC_PARAMS._replace(**MC, num_class=4, hist_subtract=False),
        device="cpu")
    for jm, tm in zip(jms, tms):
        _assert_same_forest(jm, tm)
        np.testing.assert_allclose(tm.val_margin, jm.val_margin, atol=1e-5)
    assert t_oof.shape == (400, 4) and t_test.shape == (80, 4)
    np.testing.assert_allclose(t_oof, j_oof, atol=1e-5)
    np.testing.assert_allclose(t_test, j_test, atol=1e-5)
    np.testing.assert_allclose(t_oof.sum(axis=1), 1.0, atol=1e-5)
    assert (t_oof.argmax(axis=1) == y_mc).mean() > 0.6


def test_run_v62_matches_jax():
    X, spec, y_bin = _v62_data()
    names = [f"f{i}" for i in range(10)]
    want = JP.run_v62(X, y_bin, spec, names, X[:80], mc_params=JP.V62_MC_PARAMS._replace(**MC),
                      params=JP.V34A_PARAMS._replace(**MC))
    got = TP.run_v62(X, y_bin, spec, names, X[:80],
                     mc_params=TP.V62_MC_PARAMS._replace(**MC, hist_subtract=False),
                     params=TP.V34A_PARAMS._replace(**MC, hist_subtract=False), device="cpu")
    assert got.mc_classes == want.mc_classes == ["AGN", "SN_CC", "SN_Ia", "TDE"]
    assert got.feature_names == want.feature_names
    np.testing.assert_allclose(got.mc_oof, want.mc_oof, atol=1e-5)
    np.testing.assert_allclose(got.mc_test, want.mc_test, atol=1e-5)
    assert got.mc_tde_f1 == pytest.approx(want.mc_tde_f1, abs=1e-12)
    for jm, tm in zip(want.cv.models, got.cv.models):
        _assert_same_forest(jm, tm)
    np.testing.assert_allclose(got.cv.oof_preds, want.cv.oof_preds, atol=1e-5)
    np.testing.assert_allclose(got.cv.test_preds, want.cv.test_preds, atol=1e-5)
    assert got.oof_f1 == pytest.approx(want.oof_f1, abs=1e-12)
    assert got.threshold == pytest.approx(want.threshold, abs=1e-12)


def test_simplify_spectype_and_configs():
    st = np.array(["TDE", "SN Ia", "SN II", "SN IIn", "SN Ib/c", "SLSN", "AGN"])
    np.testing.assert_array_equal(TP.simplify_spectype(st), JP.simplify_spectype(st))
    assert list(TP.simplify_spectype(st)) == ["TDE", "SN_Ia", "SN_CC", "SN_CC", "SN_CC",
                                              "SN_CC", "AGN"]
    for name in ("V110_PARAMS", "V111_PARAMS", "V118_PARAMS", "V62_MC_PARAMS"):
        t, j = getattr(TP, name), getattr(JP, name)
        for field in T.GBDTParams._fields:
            if field in J.GBDTParams._fields:
                assert getattr(t, field) == getattr(j, field), (name, field)


@pytest.mark.parametrize("bad", [dict(grow_policy="lossguide"), dict(grow_policy="symmetric"),
                                 dict(dart_rate=0.15)])
def test_multiclass_guard(bad):
    """num_class >= 2 needs depthwise growth without DART, in the port as
    in the JAX package's ``train_gbdt``."""
    X, y, _, _ = _mc_fixture(3, 9, n=60, nv=0)
    with pytest.raises(ValueError, match="num_class"):
        J.train_gbdt(X, y, J.GBDTParams(n_rounds=2, num_class=3, **bad))
    with pytest.raises(ValueError, match="num_class"):
        T.train_gbdt(X, y, T.GBDTParams(n_rounds=2, num_class=3, **bad), device="cpu")
