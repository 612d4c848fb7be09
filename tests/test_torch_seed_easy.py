"""Port vs JAX package: the seed ensemble (v104), the easy ensemble (v93),
v115 and ``train/ensembles.py``, on the CPU.

Fixtures are tests/test_seed_ensemble.py's and
tests/test_mixup_easy_ensemble.py's (10 normal columns with NaNs, ~20%
positives), at depth 3 and a few dozen rounds: the seed ensemble at 2
seeds x 3 folds (6 lanes in one batched fit, each seed with its own folds
and each lane its own scale_pos_weight), the easy ensemble at 4 balanced
subsets, v115 with five random research columns and fixed adversarial
weights. The JAX package's CPU path builds every histogram directly, so
the port runs with ``hist_subtract=False``, the same arithmetic. Bars
(tests/test_torch_cv.py, test_torch_kaggle.py): OOF and test
probabilities within atol 1e-5; F1s, thresholds and best iterations
equal; importance within rtol 1e-4 / atol 1e-3. The blends, the stacking
meta-learner and the two-stage filter hold to the same bars (the numpy
parts of them within 1e-12).
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.train import adversarial as JA
from mallorn_tpu.train import ensembles as JE
from mallorn_tpu.train import pipelines as JP
from mallorn_tpu.trees.gbdt import GBDTParams as JParams
from mallorn_tpu_torch.train import adversarial as TA
from mallorn_tpu_torch.train import ensembles as TE
from mallorn_tpu_torch.train import pipelines as TP
from mallorn_tpu_torch.trees.gbdt import GBDTParams as TParams

torch.set_num_threads(2)

FIT = dict(n_rounds=25, max_depth=3, learning_rate=0.15, subsample=0.8,
           colsample_bytree=0.8)


def _data(n=360, seed=0, f=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logit = 1.2 * X[:, 0] - 1.5 * X[:, 1] + X[:, 2]
    y = (logit + rng.normal(0, 0.6, n) > 0.8).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    Xt = rng.normal(size=(120, f)).astype(np.float32)
    return X, y, Xt


def _jp(**kw):
    return JParams(**{**FIT, **kw})


def _tp(**kw):
    return TParams(**{**FIT, **kw}, hist_subtract=False)


def test_constants_match_the_jax_package():
    assert TP.V104_SEEDS == JP.V104_SEEDS
    assert TP.V115_EXTENDED_RESEARCH == JP.V115_EXTENDED_RESEARCH


def test_run_seed_ensemble_matches_jax():
    X, y, Xt = _data()
    w = np.linspace(0.5, 2.0, len(y))
    kw = dict(sample_weight=w, seeds=(42, 123), n_folds=3, early_stopping_rounds=5)
    want = JP.run_seed_ensemble(X, y, Xt, _jp(), **kw)
    rounds = {}
    got = TP.run_seed_ensemble(X, y, Xt, _tp(), device="cpu", rounds=rounds, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    assert got[2] == want[2] and set(got[2]) == {42, 123}
    assert 1 <= rounds["fit"] <= FIT["n_rounds"]


def test_seed_ensemble_lane_is_a_train_cv():
    """Each seed's lanes are that seed's ``train_cv`` (its folds, its model
    seed, per-fold scale_pos_weight): the 2-seed average equals the average
    of two CVs."""
    X, y, Xt = _data(seed=1)
    oof, test, f1s = TP.run_seed_ensemble(X, y, Xt, _tp(), seeds=(7, 8), n_folds=3,
                                          device="cpu")
    cvs = [TP.train_cv(X, y, Xt, _tp(seed=s), n_folds=3, seed=s, device="cpu") for s in (7, 8)]
    np.testing.assert_allclose(oof, np.mean([c.oof_preds for c in cvs], 0), rtol=0, atol=1e-6)
    np.testing.assert_allclose(test, np.mean([c.test_preds for c in cvs], 0), rtol=0, atol=1e-6)
    assert f1s[7] == TP.threshold_sweep(y, cvs[0].oof_preds)[0]


def test_run_easy_ensemble_matches_jax():
    X, y, Xt = _data(seed=2)
    w = np.linspace(0.6, 1.6, len(y))
    kw = dict(n_estimators=4, undersample_ratio=1.5, sample_weight=w, seed=3)
    want = JP.run_easy_ensemble(X, y, Xt, params=_jp(n_rounds=15), **kw)
    got = TP.run_easy_ensemble(X, y, Xt, params=_tp(n_rounds=15), device="cpu", **kw)
    np.testing.assert_allclose(got.oof_preds, want.oof_preds, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.test_preds, want.test_preds, rtol=0, atol=1e-5)
    assert (got.best_f1, got.best_threshold) == (want.best_f1, want.best_threshold)
    assert len(got.models) == 4 and got.fold_f1s == []
    # no early stopping: every round counts (argmin of the dummy metric)
    assert [m.best_iteration for m in got.models] == [m.best_iteration for m in want.models]
    np.testing.assert_allclose(got.importance_gain, np.asarray(want.importance_gain),
                               rtol=1e-4, atol=1e-3)


def test_run_v115_matches_jax():
    X, y, Xt = _data(seed=3)
    rng = np.random.default_rng(4)
    names = [f"f{i}" for i in range(X.shape[1] - 2)] + list(JP.SHIFT_FEATURES)
    research = {n: rng.normal(size=len(y)).astype(np.float32)
                for n in JP.V115_EXTENDED_RESEARCH}
    research_te = {n: rng.normal(size=len(Xt)).astype(np.float32)
                   for n in JP.V115_EXTENDED_RESEARCH}
    weights = 0.5 + 1.5 * rng.random(len(y))
    adv = dict(auc=0.6, distribution_shift=True, sample_weights=weights,
               train_adv_preds=(weights - 0.5) / 1.5, importance_gain=np.zeros(8))
    want = JP.run_v115(X, y, names, research, Xt, research_te, params=_jp(),
                       adv=JA.AdversarialResult(**adv))
    got = TP.run_v115(X, y, names, {k: torch.from_numpy(v) for k, v in research.items()}, Xt,
                      research_te, params=_tp(), adv=TA.AdversarialResult(**adv),
                      device="cpu")
    assert got.feature_names == want.feature_names
    assert len(got.feature_names) == X.shape[1] - 2 + len(JP.V115_EXTENDED_RESEARCH)
    w_t, w_j = got.winner, want.winner
    assert [m.best_iteration for m in w_t.models] == [m.best_iteration for m in w_j.models]
    np.testing.assert_allclose(w_t.oof_preds, w_j.oof_preds, rtol=0, atol=1e-5)
    np.testing.assert_allclose(w_t.test_preds, w_j.test_preds, rtol=0, atol=1e-5)
    assert (w_t.best_f1, w_t.best_threshold) == (w_j.best_f1, w_j.best_threshold)
    np.testing.assert_allclose(w_t.importance_gain, np.asarray(w_j.importance_gain),
                               rtol=1e-4, atol=1e-3)


def _preds(seed=5, n=300, k=3):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.2).astype(np.float64)
    oofs = [np.clip(0.5 * y + 0.6 * rng.random(n) - 0.1 * i, 0, 1) for i in range(k)]
    oofs[0][:20] = np.round(oofs[0][:20], 1)  # tied scores
    tests = [rng.random(80) for _ in range(k)]
    return y, oofs, tests


def test_blends_match_jax():
    y, oofs, _ = _preds()
    for w in (None, (0.2, 0.5, 0.3)):
        np.testing.assert_array_equal(TE.average_blend(oofs, w), JE.average_blend(oofs, w))
    np.testing.assert_array_equal(TE.rank_average(oofs), JE.rank_average(oofs))
    for k in (2, 3):
        gw, gf, gt = TE.optimize_blend_weights(oofs[:k], y)
        ww, wf, wt = JE.optimize_blend_weights(oofs[:k], y)
        np.testing.assert_array_equal(gw, ww)
        assert (gf, gt) == (wf, wt)
    with pytest.raises(ValueError):
        TE.optimize_blend_weights(oofs[:1], y)


def test_stack_oof_matches_jax():
    y, oofs, tests = _preds(seed=6)
    for kw in (dict(), dict(add_agreement_features=False, l2=0.3, n_folds=3, seed=7)):
        got = TE.stack_oof(oofs, y, tests, **kw)
        want = JE.stack_oof(oofs, y, tests, **kw)
        np.testing.assert_allclose(got["oof_preds"], want["oof_preds"], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got["test_preds"], want["test_preds"], rtol=1e-12,
                                   atol=1e-12)
        assert (got["best_f1"], got["threshold"]) == (want["best_f1"], want["threshold"])
    w = TE._logreg_fit(np.column_stack(oofs), y)
    np.testing.assert_allclose(w, JE._logreg_fit(np.column_stack(oofs), y), rtol=1e-12)
    np.testing.assert_allclose(TE._logreg_predict(w, np.column_stack(tests)),
                               JE._logreg_predict(w, np.column_stack(tests)), rtol=1e-12)


def test_two_stage_matches_jax():
    X, y, Xt = _data(seed=7)
    w = np.linspace(0.7, 1.4, len(y))
    kw = dict(stage1_recall_threshold=0.08, sample_weight=w)
    want = JE.two_stage(X, y, Xt, _jp(n_rounds=15), _jp(n_rounds=20, max_depth=2), **kw)
    got = TE.two_stage(X, y, Xt, _tp(n_rounds=15), _tp(n_rounds=20, max_depth=2),
                       device="cpu", **kw)
    assert got["n_filtered"] == want["n_filtered"] > 0
    for k in ("oof_preds", "test_preds", "stage1_oof"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert (got["best_f1"], got["threshold"]) == (want["best_f1"], want["threshold"])
