"""Port vs JAX package: ``run_baseline`` and ``run_v34a`` on the CPU.

- ``run_baseline``: tests/test_pipeline_baseline.py's synthetic splits,
  shrunk (240 training and 120 test objects), the depthwise CV at
  ``BASELINE_PARAMS`` cut to depth 3 and 12 rounds, the leaf-wise CV at
  ``BASELINE_LGBM_PARAMS`` (31 leaves, depth cap 6, ``reg_lambda = 0``,
  ``min_child_weight = 1e-3``) cut to 5 rounds. Each package extracts its
  own statistical features from the same lightcurves.
- ``run_v34a``: tests/test_pipeline_v34a_v92.py's synthetic splits,
  shrunk to 80 + 80 objects. The four v34a families are extracted once by
  the JAX package (8 GP steps) and handed to both runners: to the JAX
  package's by replacing its ``extract_v34a_bundle`` for this test, to the
  port's as ``bundles=``. Both then run the features_v4 selection CV (top
  120 of 307), the assembly and the CV, at ``V34A_PARAMS`` cut to depth 3.

The JAX package's CPU path builds every histogram directly, so the port
runs with ``hist_subtract=False``, the same arithmetic. Bars
(tests/test_torch_cv.py, test_torch_kaggle.py): feature names, selections
and best iterations equal; OOF and test probabilities within atol 1e-5;
F1s and thresholds equal; importance within rtol 1e-4 / atol 1e-3. At
``reg_lambda = 0`` the NaN leaves of empty nodes fall where the JAX
package's do.
"""

import numpy as np
import pytest
import torch

from mallorn_tpu.data.packing import unify_time_padding as jax_unify
from mallorn_tpu.data.synthetic import generate_dataset
from mallorn_tpu.train import pipelines as JP
from mallorn_tpu.trees import gbdt as JG
from mallorn_tpu_torch.data.packing import Metadata, from_numpy
from mallorn_tpu_torch.train import pipelines as TP
from mallorn_tpu_torch.trees import gbdt as TG

torch.set_num_threads(2)


def _port_split(packed, meta):
    arrays = [np.asarray(v) for k, v in packed._asdict().items() if k != "time_offset"]
    return (from_numpy(arrays, packed.time_offset, device="cpu"),
            Metadata(object_ids=np.asarray(meta.object_ids), z=np.asarray(meta.z),
                     ebv=np.asarray(meta.ebv), target=np.asarray(meta.target)))


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
    for name in ("BASELINE_PARAMS", "BASELINE_LGBM_PARAMS", "V34A_PARAMS"):
        for k, v in getattr(TP, name)._asdict().items():
            assert getattr(getattr(JP, name), k) == v, (name, k)


@pytest.fixture(scope="module")
def baseline_splits():
    tr = generate_dataset(n_objects=240, seed=1, tde_frac=0.15)
    te = generate_dataset(n_objects=120, seed=2, tde_frac=0.15)
    return tr, te


def test_run_baseline_matches_jax(baseline_splits):
    (tr_p, tr_m, _), (te_p, te_m, _) = baseline_splits
    params = JP.BASELINE_PARAMS._replace(n_rounds=12, max_depth=3)
    lgbm = JP.BASELINE_LGBM_PARAMS._replace(n_rounds=5)
    want = JP.run_baseline(tr_p, tr_m, te_p, te_m, params=params, lgbm_params=lgbm)
    t_tr, t_te = _port_split(tr_p, tr_m), _port_split(te_p, te_m)
    got = TP.run_baseline(*t_tr, *t_te,
                          params=TP.BASELINE_PARAMS._replace(n_rounds=12, max_depth=3,
                                                             hist_subtract=False),
                          lgbm_params=TP.BASELINE_LGBM_PARAMS._replace(n_rounds=5),
                          device="cpu")
    assert got.feature_names == want.feature_names and len(got.feature_names) == 127
    _assert_same_cv(got.cv, want.cv)
    _assert_same_cv(got.lgbm_cv, want.lgbm_cv)
    assert (got.oof_f1, got.threshold) == (want.oof_f1, want.threshold)
    np.testing.assert_allclose(got.blend_test_preds, want.blend_test_preds, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.test_binary, want.test_binary)
    assert set(got.timings) == {"features_s", "train_s", "depthwise_s", "lgbm_s"}
    # the leaf-wise family's trees: at most 31 leaves with values
    for m in got.lgbm_cv.models:
        n_leaves = (m.forest.is_leaf & (m.forest.leaf_value != 0)).sum(dim=1)
        assert int(n_leaves.max()) <= 31


def test_run_baseline_without_test_or_lgbm(baseline_splits):
    (tr_p, tr_m, _), _ = baseline_splits
    got = TP.run_baseline(*_port_split(tr_p, tr_m),
                          params=TP.BASELINE_PARAMS._replace(n_rounds=5, max_depth=3),
                          lgbm_params=None, device="cpu")
    assert got.lgbm_cv is None and got.test_binary is None and got.blend_test_preds is None
    assert got.cv.oof_preds.shape == (240,) and np.isfinite(got.cv.oof_preds).all()


@pytest.fixture(scope="module")
def v34a_splits():
    tr = generate_dataset(80, seed=11, tde_frac=0.25)
    te = generate_dataset(80, seed=12, tde_frac=0.25)
    tr_p, te_p = jax_unify(tr[0], te[0])
    bundles = {"train": JP.extract_v34a_bundle(tr_p, tr[1], gp_steps=8),
               "test": JP.extract_v34a_bundle(te_p, te[1], gp_steps=8)}
    return (tr_p, tr[1]), (te_p, te[1]), bundles


def _torch_bundle(bundle):
    return {fam: {k: torch.from_numpy(np.array(v)) for k, v in fs.items()}
            for fam, fs in bundle.items()}


def test_run_v34a_matches_jax(v34a_splits, monkeypatch):
    (tr_p, tr_m), (te_p, te_m), bundles = v34a_splits
    by_split = {id(tr_p): bundles["train"], id(te_p): bundles["test"]}
    monkeypatch.setattr(JP, "extract_v34a_bundle",
                        lambda packed, meta, gp_steps: by_split[id(packed)])
    fit = dict(n_rounds=20, max_depth=3, learning_rate=0.1)
    want = JP.run_v34a(tr_p, tr_m, te_p, te_m, params=JP.V34A_PARAMS._replace(**fit),
                       gp_steps=8, selection_params=JP.V34A_PARAMS._replace(n_rounds=10,
                                                                           max_depth=3))
    port_bundles = (_torch_bundle(bundles["train"]), _torch_bundle(bundles["test"]))
    t_tr, t_te = _port_split(tr_p, tr_m), _port_split(te_p, te_m)
    got = TP.run_v34a(*t_tr, *t_te,
                      params=TP.V34A_PARAMS._replace(**fit, hist_subtract=False),
                      gp_steps=8, bundles=port_bundles, device="cpu",
                      selection_params=TP.V34A_PARAMS._replace(n_rounds=10, max_depth=3,
                                                               hist_subtract=False))
    assert got.selection.selected == want.selection.selected
    assert len(got.selection.selected) == 120
    assert got.feature_names == want.feature_names and len(got.feature_names) == 224
    _assert_same_cv(got.cv, want.cv)
    assert (got.oof_f1, got.threshold) == (want.oof_f1, want.threshold)
    np.testing.assert_allclose(got.test_preds, want.test_preds, rtol=0, atol=1e-5)

    # given the selected names, the port selects nothing and fits the same
    # CV; without a test split it predicts no test rows
    again = TP.run_v34a(*t_tr, params=TP.V34A_PARAMS._replace(**fit, hist_subtract=False),
                        bundles=(port_bundles[0], None), selected=got.selection.selected,
                        device="cpu")
    assert again.selection is None and again.test_preds is None
    assert again.feature_names == got.feature_names
    np.testing.assert_allclose(again.cv.oof_preds, got.cv.oof_preds, rtol=0, atol=0)


@pytest.mark.parametrize("policy", ["depthwise", "lossguide"])
def test_reg_lambda_zero_nan_leaves_match_jax(policy):
    """At ``BASELINE_LGBM_PARAMS``' regularisation an empty node's leaf
    weight is 0 / 0: the port's NaN leaves fall where the JAX package's do
    (an early depthwise leaf keeps it; a leaf-wise fit masks it), and the
    split arrays are equal."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 8)).astype(np.float32)
    y = ((1.5 * X[:, 0] - 2 * X[:, 1] + X[:, 2] * X[:, 3]
          + rng.normal(scale=0.5, size=600)) > 0).astype(np.float32)
    X[rng.uniform(size=600) < 0.1, 4] = np.nan
    p = TP.BASELINE_LGBM_PARAMS._replace(n_rounds=10, grow_policy=policy)
    jm = JG.train_gbdt(X, y, JG.GBDTParams(**p._asdict()))
    tm = TG.train_gbdt(X, y, p._replace(hist_subtract=False), device="cpu")
    for name in ("feature", "split_bin", "default_left", "is_leaf"):
        np.testing.assert_array_equal(getattr(tm.forest, name).numpy(),
                                      np.asarray(getattr(jm.forest, name)), err_msg=name)
    want, got = np.asarray(jm.forest.leaf_value), tm.forest.leaf_value.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() == (policy == "depthwise")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
