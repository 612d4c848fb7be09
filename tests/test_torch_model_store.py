"""Port <-> JAX package: model files.

A depthwise CV trained by the port (``train_cv``) is saved with the
port's ``save_cv_models``; the JAX package's ``load_cv_models`` reads it
and its ``predict_proba_folds`` gives the port's fold probabilities to
1e-6. The port reads its own files back to the same tensors. A
symmetric, a DART and a 3-class forest (early-stopped) round-trip port
-> port (tensors and predictions equal), JAX -> port and port -> JAX
(params and best iteration equal, ``predict_proba`` within 1e-6 of the
writer's). The format has no child pointers, so a leaf-wise model
refuses to be saved. (A JAX-trained depthwise model served by the port
is tests/test_torch_serving.py.)
"""

import json

import numpy as np
import pytest
import torch

from mallorn_tpu.io import model_store as jstore
from mallorn_tpu.trees.gbdt import predict_proba_folds
from mallorn_tpu_torch.io import model_store as tstore
from mallorn_tpu_torch.train.cv import train_cv
from mallorn_tpu_torch.trees.gbdt import GBDTParams, predict_margin_models, train_gbdt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 9)).astype(np.float32)
    y = (X[:, 0] - 0.7 * X[:, 4] + 0.5 * rng.normal(size=300) > 0.4).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    cv = train_cv(X, y, None, GBDTParams(n_rounds=30, max_depth=4, learning_rate=0.2),
                  n_folds=3, device="cpu")
    return X, cv


def test_port_saved_model_loads_in_jax_and_predicts_the_same(trained, tmp_path):
    X, cv = trained
    names = [f"c{i}" for i in range(X.shape[1])]
    tstore.save_cv_models(tmp_path, cv.models, cv.best_threshold, names)
    jmodels, man = jstore.load_cv_models(tmp_path)
    assert man == {"n_folds": 3, "threshold": cv.best_threshold, "feature_names": names}
    Xt = torch.from_numpy(X)
    want = torch.sigmoid(predict_margin_models(cv.models, Xt)).numpy()
    got = np.asarray(predict_proba_folds(jmodels, X))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for jm, tm in zip(jmodels, cv.models):
        assert jm.best_iteration == tm.best_iteration
        assert jm.params.max_depth == tm.params.max_depth
        np.testing.assert_array_equal(np.asarray(jm.bin_spec.edges), tm.bin_spec.edges.numpy())


def test_port_reads_its_own_files_back(trained, tmp_path):
    X, cv = trained
    tstore.save_cv_models(tmp_path, cv.models, cv.best_threshold, ["a"] * X.shape[1])
    models, man = tstore.load_cv_models(tmp_path, device="cpu")
    assert json.loads((tmp_path / "manifest.json").read_text()) == man
    for a, b in zip(models, cv.models):
        for x, z in zip(a.forest, b.forest):
            assert torch.equal(x, z)
        assert a.params == b.params and a.best_iteration == b.best_iteration
        np.testing.assert_array_equal(a.eval_history, b.eval_history)
        np.testing.assert_array_equal(a.importance_gain, b.importance_gain)
    assert not list(tmp_path.glob("*.tmp*"))


def test_leaf_wise_models_cannot_be_saved(trained, tmp_path):
    X, cv = trained
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
    lg = train_gbdt(X, y, GBDTParams(n_rounds=3, grow_policy="lossguide", max_leaves=4),
                    device="cpu")
    with pytest.raises(ValueError, match="child pointers"):
        tstore.save_model(tmp_path / "lg.npz", lg)
    assert not (tmp_path / "lg.npz").exists()


def test_model_files_keep_the_histogram_mode(tmp_path):
    """``hist_dtype`` travels with the params both ways: a JAX-written
    int8-mode model loads in the port with its mode, and a port-written
    int8-mode model reads back in the JAX package with its mode and its
    forest."""
    from mallorn_tpu.trees import gbdt as J

    rng = np.random.default_rng(5)
    X = rng.normal(size=(160, 6)).astype(np.float32)
    y = (X[:, 1] + 0.5 * rng.normal(size=160) > 0).astype(np.float32)
    jm = J.train_gbdt(X, y, J.GBDTParams(n_rounds=4, max_depth=3, hist_dtype="int8"))
    jstore.save_cv_models(tmp_path / "jax", [jm], 0.5, [f"c{i}" for i in range(6)])
    (got,), _ = tstore.load_cv_models(tmp_path / "jax", device="cpu")
    assert got.params.hist_dtype == "int8"
    assert got.params == GBDTParams(n_rounds=4, max_depth=3, hist_dtype="int8")

    tm = train_gbdt(X, y, GBDTParams(n_rounds=4, max_depth=3, hist_dtype="int8"), device="cpu")
    tstore.save_cv_models(tmp_path / "port", [tm], 0.5, [f"c{i}" for i in range(6)])
    (back,), _ = jstore.load_cv_models(tmp_path / "port")
    assert back.params.hist_dtype == "int8"
    assert back.params == J.GBDTParams(n_rounds=4, max_depth=3, hist_dtype="int8")
    for name in ("feature", "split_bin", "default_left", "is_leaf", "leaf_value"):
        np.testing.assert_array_equal(np.asarray(getattr(back.forest, name)),
                                      getattr(tm.forest, name).numpy(), err_msg=name)


# symmetric, DART and 3-class forests: the fixture, each config's params,
# and its predictions through either package's predict_proba
HEAP_CONFIGS = {
    "symmetric": dict(grow_policy="symmetric"),
    "dart": dict(dart_rate=0.3),
    "multiclass": dict(num_class=3, eval_metric="mlogloss"),
}


def _heap_fixture(config):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(240, 6)).astype(np.float32)
    if config == "multiclass":
        y = np.argmax(X[:, :3] + 0.5 * rng.normal(size=(240, 3)), axis=1).astype(np.float32)
    else:
        y = (X[:, 0] - 0.6 * X[:, 3] + 0.5 * rng.normal(size=240) > 0.2).astype(np.float32)
    X[rng.random(X.shape) < 0.08] = np.nan
    return X[:180], y[:180], X[180:], y[180:]


def _heap_kw(config):
    return dict(n_rounds=8, max_depth=3, learning_rate=0.3, **HEAP_CONFIGS[config])


@pytest.fixture(scope="module", params=sorted(HEAP_CONFIGS))
def heap_models(request):
    """(config, X, port-trained model, JAX-trained model) on one fixture,
    both fits early-stopped on a validation set."""
    from mallorn_tpu.trees import gbdt as J

    config = request.param
    X, y, Xv, yv = _heap_fixture(config)
    kw = _heap_kw(config)
    tm = train_gbdt(X, y, GBDTParams(**kw), X_val=Xv, y_val=yv, device="cpu")
    jm = J.train_gbdt(X, y, J.GBDTParams(**kw), X_val=Xv, y_val=yv)
    return config, np.concatenate([X, Xv]), tm, jm


def _port_proba(model, X):
    from mallorn_tpu_torch.trees.gbdt import predict_proba

    return predict_proba(model, torch.from_numpy(X)).numpy()


def test_heap_forests_round_trip_port_to_port(heap_models, tmp_path):
    config, X, tm, _ = heap_models
    path = tstore.save_model(tmp_path / "m.npz", tm)
    back = tstore.load_model(path, device="cpu")
    assert back.params == tm.params and back.best_iteration == tm.best_iteration
    for a, b in zip(back.forest, tm.forest):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(_port_proba(back, X), _port_proba(tm, X))


def test_heap_forests_round_trip_jax_to_port(heap_models, tmp_path):
    from mallorn_tpu.trees import gbdt as J

    config, X, _, jm = heap_models
    jstore.save_cv_models(tmp_path, [jm], 0.5, [f"c{i}" for i in range(X.shape[1])])
    (got,), _ = tstore.load_cv_models(tmp_path, device="cpu")
    assert got.params == GBDTParams(**_heap_kw(config))
    assert got.best_iteration == jm.best_iteration
    want = np.asarray(J.predict_proba(jm, X))
    np.testing.assert_allclose(_port_proba(got, X), want, rtol=0, atol=1e-6)


def test_heap_forests_round_trip_port_to_jax(heap_models, tmp_path):
    from mallorn_tpu.trees import gbdt as J

    config, X, tm, _ = heap_models
    tstore.save_cv_models(tmp_path, [tm], 0.5, [f"c{i}" for i in range(X.shape[1])])
    (back,), _ = jstore.load_cv_models(tmp_path)
    assert back.params == J.GBDTParams(**_heap_kw(config))
    assert back.best_iteration == tm.best_iteration
    for name in ("feature", "split_bin", "default_left", "is_leaf", "leaf_value"):
        np.testing.assert_array_equal(np.asarray(getattr(back.forest, name)),
                                      getattr(tm.forest, name).numpy(), err_msg=name)
    np.testing.assert_allclose(np.asarray(J.predict_proba(back, X)), _port_proba(tm, X),
                               rtol=0, atol=1e-6)


def test_padded_fold_models_from_a_tpu_predict_through_the_port(tmp_path):
    """A fold CV trained with ``pad_features_to=32`` (as the JAX package
    pads features on a TPU) carries edges for 32 columns; the port NaN-pads
    a 10-column matrix to the models' width in ``predict_proba_folds``,
    ``predict_proba`` and ``predict_margin``, as the JAX package does."""
    from mallorn_tpu.trees import gbdt as J
    from mallorn_tpu_torch.trees import gbdt as T
    from mallorn_tpu_torch.trees import predict_margin

    rng = np.random.default_rng(21)
    X = rng.normal(size=(400, 10)).astype(np.float32)
    y = (X[:, 1] + 0.8 * X[:, 6] + 0.5 * rng.normal(size=400) > 0.2).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    folds = [dict(X=X[idx], y=y[idx], X_val=X[va], y_val=y[va], spw=1.0)
             for idx, va in ((np.arange(0, 300), np.arange(300, 400)),
                             (np.arange(100, 400), np.arange(0, 100)))]
    jms = J.train_gbdt_folds(folds, J.GBDTParams(n_rounds=12, max_depth=3, learning_rate=0.3),
                             early_stopping_rounds=4, pad_features_to=32)
    assert jms[0].bin_spec.edges.shape[0] == 32
    jstore.save_cv_models(tmp_path, jms, 0.5, [f"c{i}" for i in range(32)])
    tms, _ = tstore.load_cv_models(tmp_path, device="cpu")
    assert tms[0].bin_spec.edges.shape[0] == 32
    np.testing.assert_allclose(T.predict_proba_folds(tms, X),
                               np.asarray(predict_proba_folds(jms, X)), rtol=0, atol=1e-6)
    for jm, tm in zip(jms, tms):
        np.testing.assert_allclose(T.predict_proba(tm, X).numpy(),
                                   np.asarray(J.predict_proba(jm, X)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(predict_margin(tm, X).numpy(),
                                   np.asarray(J.predict_margin(jm, X)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(predict_margin(tm, X, n_trees=3).numpy(),
                                   np.asarray(J.predict_margin(jm, X, n_trees=3)), rtol=0,
                                   atol=1e-6)
