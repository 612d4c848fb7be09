"""Port vs JAX package: the three host (numpy) feature families the
command line appends to the v34a backbone.

- ``features.extinction`` (v57): ``color_excess`` and ``dered_matrix``,
  with its deliberately loose substring match (``*_g_rise*`` gets a twin);
- ``features.categorical`` (v45): ``add_categorical_features``, each
  binning helper and ``ordered_target_encoding``;
- ``features.interactions`` (v105): ``create_physics_interactions`` and
  ``select_top_interactions``, whose point-biserial test the port computes
  in numpy (scipy's r bit for bit, its p-value to 1e-9 relative).

Every output equals the JAX package's exactly: the same values, names and
order.
"""

import numpy as np
import pytest
from scipy.stats import pointbiserialr

from mallorn_tpu.features import categorical as jcat
from mallorn_tpu.features import extinction as jext
from mallorn_tpu.features import interactions as jint
from mallorn_tpu_torch.features import categorical as tcat
from mallorn_tpu_torch.features import extinction as text
from mallorn_tpu_torch.features import interactions as tint

N = 400

# every column the interactions and the categorical bins read, plus noise
NAMES = ("Z", "g_r_at_peak", "g_r_post_20d", "g_r_post_50d", "r_i_at_peak",
         "gp_gr_color_20d", "gp_gr_color_50d", "gp_ri_color_20d", "temp_at_peak",
         "temp_post_50d", "g_peak_flux", "r_peak_flux", "i_peak_flux", "g_duration_50",
         "r_duration_50", "i_duration_50", "gp2d_time_scale", "gp2d_wave_scale",
         "g_amplitude", "r_amplitude", "i_amplitude", "g_rise_time", "r_rise_time",
         "g_fade_time_50", "r_fade_time_50", "g_r_slope_50d", "g_r_slope_100d",
         "g_skew", "r_skew", "i_skew", "g_std", "r_std", "i_std", "u_g_peak_flux_ratio",
         "g_r_peak_flux_ratio", "flux_p25", "g_r_peak", "r_i_peak", "r_bazin_tau_rise",
         "r_bazin_tau_fall", "r_asymmetry", "r_bazin_fit_chi2", "excess_variance",
         "i_z_color_mean", "u_g_rise_slope", "r_i_dered_mean")


def _features(seed=0):
    """{name: [N] float64} with NaNs, a constant column and a label-driven
    signal in some columns; the labels [N]."""
    rng = np.random.default_rng(seed)
    y = (rng.random(N) < 0.12).astype(np.int64)
    feats = {}
    for j, n in enumerate(NAMES):
        v = rng.normal(loc=j % 5, scale=1.0 + j % 3, size=N)
        if j % 4 == 0:
            v = v + 0.8 * y * (1 + j % 3)  # correlated with the label
        if j % 7 == 3:
            v = np.abs(v) * 40.0  # timescales / positive columns
        v[rng.random(N) < 0.1] = np.nan
        feats[n] = v
    feats["Z"] = np.abs(rng.normal(0.4, 0.3, size=N))
    feats["flux_p25"] = np.full(N, 2.5)  # constant: no correlation
    return feats, y


def test_color_excess_and_dered_matrix_match_jax():
    feats, _ = _features(1)
    X = np.stack([feats[n] for n in NAMES], axis=1).astype(np.float32)
    ebv = np.random.default_rng(2).uniform(-0.05, 0.3, size=N)
    ebv[::17] = np.nan
    for b1, b2 in text.COLOR_PAIRS:
        np.testing.assert_array_equal(text.color_excess(ebv, b1, b2),
                                      jext.color_excess(ebv, b1, b2))
    got, got_names = text.dered_matrix(X, NAMES, ebv)
    want, want_names = jext.dered_matrix(X, NAMES, ebv)
    assert got_names == want_names and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the loose match: a non-color name holding a pair key gets a twin,
    # and a name already dereddened does not
    assert "g_r_deredise_time" in got_names and "r_i_dered_dered_mean" not in got_names
    none, none_names = text.dered_matrix(X[:, :1], ["Z"], ebv)
    assert none.shape == (N, 0) and none_names == []


def test_categorical_features_match_jax():
    feats, _ = _features(3)
    got, got_names = tcat.add_categorical_features(feats)
    want, want_names = jcat.add_categorical_features(feats)
    assert got_names == want_names and len(got_names) == 10
    for k in want_names:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # too few finite values: every bin stays category 0
    sparse = np.full(N, np.nan)
    sparse[:5] = 1.0
    for fn in ("color_categories", "timescale_categories", "brightness_categories",
               "asymmetry_categories", "fit_quality_categories", "variability_categories"):
        np.testing.assert_array_equal(getattr(tcat, fn)(sparse), getattr(jcat, fn)(sparse))


def test_ordered_target_encoding_matches_jax():
    rng = np.random.default_rng(4)
    cat_tr = rng.integers(0, 6, size=N)
    y = (rng.random(N) < 0.2).astype(np.int64)
    cat_te = rng.integers(0, 8, size=150)  # categories 6, 7 unseen in training
    got = tcat.ordered_target_encoding(cat_tr, y, cat_te, n_permutations=3, seed=9)
    want = jcat.ordered_target_encoding(cat_tr, y, cat_te, n_permutations=3, seed=9)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    enc, none = tcat.ordered_target_encoding(cat_tr, y)
    assert none is None
    np.testing.assert_array_equal(enc, jcat.ordered_target_encoding(cat_tr, y)[0])


def test_physics_interactions_and_selection_match_jax():
    feats, y = _features(5)
    got = tint.create_physics_interactions(feats)
    want = jint.create_physics_interactions(feats)
    assert list(got) == list(want) and len(got) > 40
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for top_k in (5, 30):
        keep = tint.select_top_interactions(got, y, top_k=top_k)
        assert keep == jint.select_top_interactions(want, y, top_k=top_k)
        assert 0 < len(keep) <= top_k


@pytest.mark.parametrize("n", [3, 60, 2500])
def test_point_biserial_matches_scipy(n):
    rng = np.random.default_rng(n)
    for trial in range(20):
        x = (rng.random(n) < 0.3).astype(np.int64)
        x[:2] = (0, 1)
        v = rng.normal(size=n) * 10.0 ** (trial % 5) + x * rng.normal() + 1e3 * (trial % 2)
        r, p = tint.pointbiserialr(x, v)
        want = pointbiserialr(x, v)
        assert r == want.statistic
        np.testing.assert_allclose(p, want.pvalue, rtol=1e-9, atol=1e-300)
    assert np.isnan(tint.pointbiserialr(np.zeros(n, int), np.arange(n))[0])
