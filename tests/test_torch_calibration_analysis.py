"""Port vs JAX package: ``train/calibration.py``, ``train/analysis.py`` and
``train/visualize.py``.

- Calibration: ``platt_scale`` and ``threshold_variants`` equal the JAX
  package's exactly; ``isotonic_calibrate`` (pool-adjacent-violators in
  numpy where the JAX package calls scikit-learn) equals it exactly on
  OOF vectors full of tied values, in float64 and in float32, including
  predictions outside the OOF range (clipped).
- Analysis: each function's ``Table`` (column name -> numpy array) against
  the JAX package's DataFrame, column by column: the same columns in the
  same order, the same values. Rows that tie on a single sort key may come
  in another order in pandas (its sort is not stable), so those tie
  groups are compared as multisets; every fixture here has ties.
- Visualize (when matplotlib is installed): every figure is written, and
  the confusion matrix draws the JAX package's counts.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from mallorn_tpu.train import analysis as janalysis
from mallorn_tpu.train import calibration as jcal
from mallorn_tpu_torch.train import analysis as tanalysis
from mallorn_tpu_torch.train import calibration as tcal


def _oof(n=600, seed=0, decimals=2):
    """(y, OOF probabilities rounded to ``decimals`` places: many ties)."""
    rng = np.random.default_rng(seed)
    p_true = rng.uniform(0.02, 0.98, n)
    y = (rng.uniform(size=n) < p_true).astype(np.int64)
    z = np.log(p_true / (1 - p_true))
    return y, np.round(1 / (1 + np.exp(-2.5 * z)), decimals)


def test_platt_scale_matches_jax():
    y, p = _oof()
    preds = np.random.default_rng(1).uniform(0, 1, 300)
    got, ab = tcal.platt_scale(p, y, preds)
    want, ab_j = jcal.platt_scale(p, y, preds)
    np.testing.assert_array_equal(got, want)
    assert ab == ab_j


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed,decimals", [(2, 1), (3, 2), (4, 3)])
def test_isotonic_matches_sklearn_with_ties(dtype, seed, decimals):
    y, p = _oof(seed=seed, decimals=decimals)
    p = p.astype(dtype)
    assert len(np.unique(p)) < len(p)  # ties
    preds = np.concatenate([np.random.default_rng(seed).uniform(-0.1, 1.1, 400),
                            p[:50], [p.min(), p.max()]]).astype(dtype)
    got = tcal.isotonic_calibrate(p, y, preds)
    want = jcal.isotonic_calibrate(p, y, preds)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (np.diff(tcal.isotonic_calibrate(p, y, np.sort(preds))) >= 0).all()


def test_isotonic_of_one_distinct_value_is_constant():
    y = np.array([0, 1, 1, 0, 1])
    p = np.full(5, 0.3)
    np.testing.assert_array_equal(tcal.isotonic_calibrate(p, y, np.array([0.1, 0.9])),
                                  jcal.isotonic_calibrate(p, y, np.array([0.1, 0.9])))


def test_threshold_variants_match_jax():
    preds = np.random.default_rng(5).uniform(0, 1, 200)
    got = tcal.threshold_variants(preds, [0.3, 0.5, 0.7])
    want = jcal.threshold_variants(preds, [0.3, 0.5, 0.7])
    assert list(got) == list(want)
    for t in want:
        np.testing.assert_array_equal(got[t], want[t])


def _assert_table_equals_frame(got: dict, want, key=None, whole=None):
    """Columns and values equal; rows that tie on the single sort ``key``
    compared as multisets of rows. Where ``want`` is the head of the frame
    ``whole``, which rows of the last tie group it holds is not defined
    either: those rows are held to be rows of ``whole``'s group."""
    assert list(got) == list(want.columns)
    assert tanalysis.table_len(got) == len(want)
    cols = list(want.columns)

    def cell(x):  # NaN equals NaN here
        return "nan" if isinstance(x, (float, np.floating)) and np.isnan(x) else x

    g_rows = [tuple(cell(got[c][i]) for c in cols) for i in range(len(want))]
    w_rows = [tuple(cell(want[c].iloc[i]) for c in cols) for i in range(len(want))]
    if key is None:
        assert g_rows == w_rows
        return
    k = cols.index(key)
    g_keys = [r[k] for r in g_rows]
    assert g_keys == [r[k] for r in w_rows]  # the sort key's sequence is equal
    for v in set(g_keys):
        g_group = Counter(r for r in g_rows if r[k] == v)
        if whole is not None and v == g_keys[-1]:
            pool = {tuple(cell(whole[c].iloc[i]) for c in cols) for i in range(len(whole))}
            assert set(g_group) <= pool, v
        else:
            assert g_group == Counter(r for r in w_rows if r[k] == v), v


def test_importance_report_matches_jax():
    names = [f"f{i}" for i in range(40)]
    gains = np.round(np.random.default_rng(6).exponential(2.0, 40), 0)  # ties, zeros
    whole = janalysis.importance_report(names, gains, 60)
    for top_k in (5, 30, 60):
        _assert_table_equals_frame(tanalysis.importance_report(names, gains, top_k),
                                   janalysis.importance_report(names, gains, top_k), "gain",
                                   whole)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_distribution_drift_matches_jax(dtype):
    rng = np.random.default_rng(7)
    Xa = rng.normal(size=(300, 12)).astype(dtype)
    Xb = rng.normal(size=(250, 12)).astype(dtype)
    Xb[:, 2] += 3.0
    Xa[:, 5] = Xb[:, 5] = 1.0  # constant: shift 0, a tie with column 6
    Xa[:, 6] = Xb[:, 6] = 2.0
    Xa[rng.random(Xa.shape) < 0.2] = np.nan
    Xa[:298, 9] = np.nan  # too few finite values: no row
    names = [f"c{i}" for i in range(12)]
    whole = janalysis.distribution_drift(Xa, Xb, names, 20)
    for top_k in (4, 20):
        _assert_table_equals_frame(tanalysis.distribution_drift(Xa, Xb, names, top_k),
                                   janalysis.distribution_drift(Xa, Xb, names, top_k),
                                   "shift_sigma", whole)


def test_compare_experiments_matches_jax():
    results = {"v1": {"oof_f1": 0.3, "threshold": 0.5},
               "v2": {"oof_f1": 0.7, "threshold": 0.4, "adv_auc": 0.7},
               "v3": {"oof_f1": 0.3, "n_features": 224, "weights": [0.5, 0.5]},
               "v4": {"threshold": 0.2}}
    _assert_table_equals_frame(tanalysis.compare_experiments(results),
                               janalysis.compare_experiments(results), "oof_f1")


def _report_inputs(seed=11, n=400):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=n) < 0.1).astype(int)
    p = np.round(np.where(y == 1, 0.8, 0.1) + rng.normal(0, 0.05, n), 2)
    p[np.where(y == 1)[0][:3]] = [0.05, 0.2, 0.45]
    p[np.where(y == 0)[0][:4]] = 0.9  # four FPs at one probability
    X = rng.normal(size=(n, 6))
    X[:, 2] += 3.0 * y
    X[rng.random(X.shape) < 0.05] = np.nan
    return dict(y=y, oof_preds=p, threshold=0.5, X=X,
                feature_names=[f"f{i}" for i in range(6)],
                importance_gain=np.array([0.1, 0.2, 5.0, 0.3, 0.1, 0.7]),
                object_ids=np.arange(1000, 1000 + n), z=np.linspace(0, 1, n),
                spec_type=np.array(["TDE" if t else "SN" for t in y]),
                other_models={"alt": np.where(y == 1, 0.9, 0.1),
                              "weak": rng.uniform(size=n)})


def test_error_analysis_matches_jax(capsys):
    kw = _report_inputs()
    got = tanalysis.error_analysis(**kw)
    want = janalysis.error_analysis(**kw)
    assert list(got) == list(want)
    for k in ("confusion", "hard_tde_count", "fn_recovery"):
        assert got[k] == want[k], k
    for g in want["confidence"]:
        for k, v in want["confidence"][g].items():
            np.testing.assert_array_equal(got["confidence"][g][k], v)
    # (group, oof_prob) is a stable lexicographic sort in both
    _assert_table_equals_frame(got["errors"], want["errors"])
    _assert_table_equals_frame(got["group_stats"], want["group_stats"], "fn_tp_gap")
    # without X, ids, z or other models
    bare = dict(y=kw["y"], oof_preds=kw["oof_preds"], threshold=0.3)
    got, want = tanalysis.error_analysis(**bare), janalysis.error_analysis(**bare)
    assert list(got) == list(want)
    _assert_table_equals_frame(got["errors"], want["errors"])

    tanalysis.print_error_analysis(tanalysis.error_analysis(**kw))
    out = capsys.readouterr().out
    c = janalysis.error_analysis(**kw)["confusion"]
    assert f"TP={c['tp']} FP={c['fp']} FN={c['fn']} TN={c['tn']}" in out
    assert "misclassified objects" in out and "FN recovery" in out and "f2" in out


def test_prediction_agreement_matches_jax():
    rng = np.random.default_rng(12)
    preds = {n: rng.uniform(size=300) for n in ("v92d", "v34a", "ensemble")}
    preds["same"] = preds["v92d"].copy()
    got = tanalysis.prediction_agreement(preds, 0.4)
    want = janalysis.prediction_agreement(preds, 0.4)
    assert list(got) == list(want.columns) == list(want.index)
    for c in want.columns:
        np.testing.assert_array_equal(got[c], want[c].to_numpy())


def test_visualizations_write_pngs_and_draw_the_same_counts(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    from mallorn_tpu.data.synthetic import generate_dataset
    from mallorn_tpu.train import visualize as jvis
    from mallorn_tpu_torch.data.packing import from_numpy
    from mallorn_tpu_torch.train import visualize as tvis

    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 200)
    preds = np.clip(y * 0.6 + rng.uniform(0, 0.4, 200), 0, 1)
    packed, meta, _ = generate_dataset(4, seed=5)
    tpacked = from_numpy([np.asarray(x) for x in packed[:-1]], packed.time_offset,
                         device="cpu")
    torch.set_num_threads(2)

    paths = [
        tvis.plot_confusion(y, preds, 0.4, tmp_path / "cm.png"),
        tvis.plot_importance([f"f{i}" for i in range(30)], rng.exponential(1, 30),
                             tmp_path / "imp.png"),
        tvis.plot_prediction_distribution(preds, y, 0.4, tmp_path / "dist.png"),
        tvis.plot_adversarial_weights(0.5 + 1.5 * preds, tmp_path / "w.png"),
        tvis.plot_lightcurve(tpacked, 0, tmp_path / "lc.png", meta.object_ids[0]),
    ]
    for p in paths:
        assert p.exists() and p.stat().st_size > 2000, p

    def counts(vis):
        drawn = []
        monkeypatch.setattr(vis, "_save", lambda fig, path: drawn.append(
            [t.get_text() for t in fig.axes[0].texts]))
        vis.plot_confusion(y, preds, 0.4, tmp_path / "x.png")
        return drawn[0]

    got, want = counts(tvis), counts(jvis)
    assert got == want and len(got) == 4
    assert sum(int(t) for t in got) == len(y)
