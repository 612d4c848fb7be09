"""v45 physics-category binning of continuous features (port of
``mallorn_tpu.features.categorical``; host numpy, the JAX package's code).

Host-side port of reference src/features/catboost_categorical.py:21-159
(the module is plain NumPy binning in the reference too; CatBoost itself
is an optional GBM family — the bins feed our tree layer directly as
small-cardinality integer features):

- redshift: fixed thresholds 0.1 / 0.3 / 0.6;
- colors: blue/normal/red at the 25th/75th percentiles;
- timescales: fast/medium/slow at 20 / 100 days;
- brightness: terciles; asymmetry: 2 / 10; fit-quality chi2: terciles of
  the positive values (good fit = low chi2); variability: terciles.
Bins with fewer than 10 finite values stay category 0.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Features = Dict[str, np.ndarray]


def redshift_categories(z):
    c = np.zeros(len(z), dtype=np.int32)
    c[(z >= 0.1) & (z < 0.3)] = 1
    c[(z >= 0.3) & (z < 0.6)] = 2
    c[z >= 0.6] = 3
    return c


def color_categories(colors):
    c = np.zeros(len(colors), dtype=np.int32)
    if np.isfinite(colors).sum() > 10:
        q25, q75 = np.nanpercentile(colors, [25, 75])
        c[(colors >= q25) & (colors < q75)] = 1
        c[colors >= q75] = 2
    return c


def timescale_categories(times):
    c = np.zeros(len(times), dtype=np.int32)
    if np.isfinite(times).sum() > 10:
        c[(times >= 20) & (times < 100)] = 1
        c[times >= 100] = 2
    return c


def brightness_categories(fluxes):
    c = np.zeros(len(fluxes), dtype=np.int32)
    if np.isfinite(fluxes).sum() > 10:
        q33, q67 = np.nanpercentile(fluxes, [33, 67])
        c[(fluxes >= q33) & (fluxes < q67)] = 1
        c[fluxes >= q67] = 2
    return c


def asymmetry_categories(asym):
    c = np.zeros(len(asym), dtype=np.int32)
    if (np.isfinite(asym) & (asym > 0)).sum() > 10:
        c[(asym >= 2) & (asym < 10)] = 1
        c[asym >= 10] = 2
    return c


def fit_quality_categories(chi2):
    c = np.zeros(len(chi2), dtype=np.int32)
    valid = np.isfinite(chi2) & (chi2 > 0)
    if valid.sum() > 10:
        q33, q67 = np.nanpercentile(chi2[valid], [33, 67])
        c[chi2 <= q33] = 2
        c[(chi2 > q33) & (chi2 <= q67)] = 1
    return c


def variability_categories(var):
    c = np.zeros(len(var), dtype=np.int32)
    if np.isfinite(var).sum() > 10:
        q33, q67 = np.nanpercentile(var, [33, 67])
        c[(var >= q33) & (var < q67)] = 1
        c[var >= q67] = 2
    return c


_SOURCES = (
    ("Z", redshift_categories, "z_category"),
    ("g_r_peak", color_categories, "gr_color_category"),
    ("r_i_peak", color_categories, "ri_color_category"),
    ("r_bazin_tau_rise", timescale_categories, "rise_time_category"),
    ("r_bazin_tau_fall", timescale_categories, "fall_time_category"),
    ("r_duration_50", timescale_categories, "duration_category"),
    ("r_peak_flux", brightness_categories, "brightness_category"),
    ("r_asymmetry", asymmetry_categories, "asymmetry_category"),
    ("r_bazin_fit_chi2", fit_quality_categories, "fit_quality_category"),
    ("excess_variance", variability_categories, "variability_category"),
)


def add_categorical_features(feats: Features) -> Tuple[Features, List[str]]:
    """Returns (new categorical columns, their names)."""
    out: Features = {}
    for src, fn, name in _SOURCES:
        if src in feats:
            out[name] = fn(np.asarray(feats[src], dtype=np.float64)).astype(np.float32)
    return out, list(out.keys())


def ordered_target_encoding(
    cat_train: np.ndarray,
    y: np.ndarray,
    cat_test: np.ndarray = None,
    n_permutations: int = 4,
    prior_weight: float = 1.0,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray]:
    """CatBoost's ordered target statistic for one categorical column.

    For a random permutation, each row is encoded using only the target
    values of SAME-CATEGORY rows that precede it:

        enc_i = (sum_{j<i, cat_j=cat_i} y_j + prior * w) / (count + w)

    averaged over ``n_permutations`` permutations — CatBoost's device for
    target encoding without target leakage (its 'ordered boosting'
    statistic; the reference marks CatBoost itself optional, SURVEY §2.1,
    but this is the algorithmic core worth owning natively). Test rows are
    encoded with the full-training statistics.

    Returns (enc_train [N], enc_test [M] or None) float32.
    """
    rng = np.random.default_rng(seed)
    cat = np.asarray(cat_train)
    y = np.asarray(y, np.float64)
    n = len(cat)
    prior = float(y.mean()) if n else 0.0

    enc = np.zeros(n, np.float64)
    for _ in range(n_permutations):
        perm = rng.permutation(n)
        # position of each row in the permutation; sort rows by
        # (category, position) so a shifted per-group cumsum gives the
        # preceding-rows statistics in O(n log n), no python loop
        pos = np.empty(n, np.int64)
        pos[perm] = np.arange(n)
        order = np.lexsort((pos, cat))
        yc = y[order]
        cc = cat[order]
        csum = np.cumsum(yc) - yc  # exclusive prefix sum
        cnt = np.arange(n, dtype=np.float64)
        # subtract the prefix up to the start of each category group
        grp_start = np.zeros(n, bool)
        grp_start[0] = True
        grp_start[1:] = cc[1:] != cc[:-1]
        start_idx = np.maximum.accumulate(np.where(grp_start, np.arange(n), 0))
        csum -= (np.cumsum(yc) - yc)[start_idx]
        cnt -= cnt[start_idx]
        e = (csum + prior * prior_weight) / (cnt + prior_weight)
        enc[order] += e
    enc /= n_permutations

    enc_test = None
    if cat_test is not None:
        cat_test = np.asarray(cat_test)
        sums: Dict = {}
        cnts: Dict = {}
        for c in np.unique(cat):
            m = cat == c
            sums[c] = y[m].sum()
            cnts[c] = m.sum()
        enc_test = np.array([
            (sums.get(c, 0.0) + prior * prior_weight)
            / (cnts.get(c, 0) + prior_weight)
            for c in cat_test])
    return (enc.astype(np.float32),
            enc_test.astype(np.float32) if enc_test is not None else None)
