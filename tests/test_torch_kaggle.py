"""Port vs JAX package: the shipped Kaggle ensemble (``run_kaggle_ensemble``),
the whole slice on the CPU.

The fixture is tests/test_kaggle_ensemble.py's (160 training and 80 test
rows, 12 columns of which the last two are the shift features, random
research columns, 2 model seeds, 3 folds, 8 rounds, depth 3 for the
depthwise members, v114d's leaf-wise params at 8 rounds). Both packages
run the ensemble once per module. The per-model seed-averaged OOF and
test probabilities must agree within 1e-5, the adversarial weights
within 1e-5, and the blend's F1 and threshold must be equal. The
notebook's contract (fixed folds shared by every model and seed, the LB
weight table, the NaN policy, v92d = v34a under flat weights) is held on
the port alone.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.train import pipelines as J
from mallorn_tpu_torch.train import pipelines as T
from mallorn_tpu_torch.train.adversarial import AdversarialResult
from mallorn_tpu_torch.train.cv import stratified_kfold

torch.set_num_threads(2)

N, NTE, F = 160, 80, 12


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    names = [f"f{i}" for i in range(F - 2)] + list(J.SHIFT_FEATURES)
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = (0.9 * X[:, 0] - 0.5 * X[:, 3] + 0.5 * rng.normal(size=N) > 0.6)
    Xte = rng.normal(size=(NTE, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[3, 2] = np.inf
    research = {n: rng.normal(size=N).astype(np.float32) for n in J.V115_MINIMAL_RESEARCH}
    research_te = {n: rng.normal(size=NTE).astype(np.float32)
                   for n in J.V115_MINIMAL_RESEARCH}
    return X, y.astype(np.float32), Xte, names, research, research_te


def _run(pkg, data, **kw):
    X, y, Xte, names, research, research_te = data
    if pkg is T:
        research = {k: torch.from_numpy(v) for k, v in research.items()}
        kw["device"] = "cpu"
    return pkg.run_kaggle_ensemble(
        X, y, names, research, Xte, research_te,
        xgb_params=pkg.V34A_PARAMS._replace(n_rounds=8, max_depth=3),
        lgbm_params=pkg.V114D_PARAMS._replace(n_rounds=8), seeds=(42, 123), n_folds=3, **kw)


@pytest.fixture(scope="module")
def both(data):
    return _run(J, data), _run(T, data)


def test_constants_match_the_jax_package():
    assert T.V115_MINIMAL_RESEARCH == J.V115_MINIMAL_RESEARCH
    assert T.KAGGLE_MODEL_SEEDS == J.KAGGLE_MODEL_SEEDS
    assert T.KAGGLE_CV_SEED == J.KAGGLE_CV_SEED
    assert T.KAGGLE_ENSEMBLE_WEIGHTS == J.KAGGLE_ENSEMBLE_WEIGHTS
    for k, v in T.V114D_PARAMS._asdict().items():
        assert getattr(J.V114D_PARAMS, k) == v, k


@pytest.mark.parametrize("model", ["v92d", "v34a", "v114d"])
def test_member_matches_jax(both, model):
    want, got = both
    w, g = want.per_model[model], got.per_model[model]
    np.testing.assert_allclose(g["oof"], w["oof"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g["test"], w["test"], rtol=0, atol=1e-5)
    assert g["oof_f1"] == pytest.approx(w["oof_f1"], abs=1e-12)
    assert g["threshold"] == pytest.approx(w["threshold"], abs=1e-12)
    assert set(g["seed_f1s"]) == set(w["seed_f1s"]) == {42, 123}
    assert 1 <= g["rounds_run"] <= 8


def test_blend_and_adversarial_match_jax(both):
    want, got = both
    np.testing.assert_allclose(got.adversarial.sample_weights,
                               want.adversarial.sample_weights, atol=1e-5)
    assert got.adversarial.auc == pytest.approx(want.adversarial.auc, abs=1e-9)
    np.testing.assert_allclose(got.ensemble_oof, want.ensemble_oof, atol=1e-5)
    np.testing.assert_allclose(got.ensemble_test, want.ensemble_test, atol=1e-5)
    assert got.oof_f1 == want.oof_f1 and got.threshold == want.threshold


def test_contract(both):
    _, out = both
    assert set(out.per_model) == {"v92d", "v34a", "v114d"}
    for m in out.per_model.values():
        assert m["oof"].shape == (N,) and m["test"].shape == (NTE,)
        assert np.isfinite(m["oof"]).all() and np.isfinite(m["test"]).all()
    want = sum(T.KAGGLE_ENSEMBLE_WEIGHTS[k] * out.per_model[k]["oof"] for k in out.per_model)
    np.testing.assert_allclose(out.ensemble_oof, want, rtol=1e-6)
    want_te = sum(T.KAGGLE_ENSEMBLE_WEIGHTS[k] * out.per_model[k]["test"]
                  for k in out.per_model)
    np.testing.assert_allclose(out.ensemble_test, want_te, rtol=1e-6)
    assert 0.03 <= out.threshold <= 0.5 and np.isfinite(out.oof_f1)
    w = out.adversarial.sample_weights
    assert w.min() >= 0.5 - 1e-6 and w.max() <= 2.0 + 1e-6


def test_fixed_folds_are_scikit_learns():
    from sklearn.model_selection import StratifiedKFold

    y = (np.random.default_rng(1).random(N) < 0.2).astype(np.float32)
    want = StratifiedKFold(n_splits=5, shuffle=True, random_state=T.KAGGLE_CV_SEED).split(
        np.zeros((N, 1)), y)
    for (a, b), (c, d) in zip(stratified_kfold(y, 5, T.KAGGLE_CV_SEED), want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_v92d_and_v34a_differ_only_by_weights(data):
    flat = AdversarialResult(auc=0.5, distribution_shift=False, sample_weights=np.ones(N),
                             train_adv_preds=np.zeros(N), importance_gain=np.zeros(F - 2))
    out = _run(T, data, adv=flat)
    np.testing.assert_allclose(out.per_model["v92d"]["oof"], out.per_model["v34a"]["oof"],
                               rtol=1e-5, atol=1e-6)


def test_kaggle_nan_policy():
    X = np.array([[np.nan, np.inf, -np.inf, 1.5]], np.float32)
    np.testing.assert_array_equal(T._kaggle_nan(X), [[0.0, 1e10, -1e10, 1.5]])


def test_train_kaggle_ensemble_from_packed_splits():
    """The slice from packed lightcurves on the CPU at a tiny size: the
    v34a families and the research family of both splits, the selection,
    the 224-style assembly and the ensemble, with each stage timed."""
    from mallorn_tpu.data.synthetic import generate_dataset
    from mallorn_tpu_torch.data.packing import Metadata, from_numpy

    def split(n, seed):
        packed, meta, _ = generate_dataset(n_objects=n, seed=seed, tde_frac=0.3)
        tp = from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset,
                        device="cpu")
        return tp, Metadata(object_ids=np.asarray(meta.object_ids), z=np.asarray(meta.z),
                            ebv=np.asarray(meta.ebv), target=np.asarray(meta.target))

    (tr, tr_meta), (te, te_meta) = split(50, 21), split(30, 22)
    out = T.train_kaggle_ensemble(
        tr, tr_meta, te, te_meta, gp_steps=4, top_k=20,
        params=T.V34A_PARAMS._replace(n_rounds=4, max_depth=3),
        lgbm_params=T.V114D_PARAMS._replace(n_rounds=4), seeds=(42,), device="cpu")
    r = out.result
    assert set(r.per_model) == {"v92d", "v34a", "v114d"}
    for m in r.per_model.values():
        assert m["oof"].shape == (50,) and m["test"].shape == (30,)
        assert np.isfinite(m["oof"]).all() and np.isfinite(m["test"]).all()
    assert len(out.feature_names) > 20
    for k in ("selection", "research", "adversarial", "v92d", "v34a", "v114d", "total"):
        assert out.timings[k] >= 0.0, k
    assert set(out.rounds_run) == {"selection", "adversarial", "v92d", "v34a", "v114d"}
    assert out.test_f1 is not None and 0.0 <= out.test_f1 <= 1.0
