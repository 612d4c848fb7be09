"""Per-band + aggregate statistical features (port of
``mallorn_tpu.features.statistical``).

The 17 per-band statistics are masked reductions over the packed
``[N, 6, T]`` view; the same code reduces the ``[N, TA]`` all-band view.
NaN/default rules as the reference: a missing band keeps n_obs = 0 and
NaN elsewhere; std is 0 for n = 1; skew/kurtosis 0 under their guards;
max_slope over time-sorted consecutive pairs with dt > 0.
"""

from __future__ import annotations

from typing import Dict

import torch

from mallorn_tpu_torch.features.base import FeatureSet, per_object, sorted_features
from mallorn_tpu_torch.ops import masked as M
from mallorn_tpu_torch.utils.constants import LSST_BANDS

_NAN = float("nan")

STAT_NAMES = (
    "n_obs", "mean", "std", "min", "max", "median", "skew", "kurtosis",
    "amplitude", "mad", "iqr", "beyond_1std", "beyond_2std", "max_slope",
    "mean_snr", "time_span", "cadence_mean",
)


def _series_stats(t, f, e, mask) -> Dict[str, torch.Tensor]:
    """Stats of time-sorted (t, f, e, mask) rows, reducing the last axis."""
    n = M.count(mask)
    empty = n == 0

    out = {
        "n_obs": n.to(f.dtype),
        "mean": M.mean(f, mask),
        "std": torch.where(n > 1, M.std(f, mask, ddof=0), 0.0),
        "min": M.mmin(f, mask),
        "max": M.mmax(f, mask),
        "median": M.median(f, mask),
        "skew": torch.where(n > 2, M.skewness(f, mask), 0.0),
        "kurtosis": torch.where(n > 2, M.kurtosis(f, mask), 0.0),
    }
    out["amplitude"] = out["max"] - out["min"]
    out["mad"] = M.mad(f, mask)
    out["iqr"] = torch.where(n > 1, M.iqr(f, mask), 0.0)
    out["beyond_1std"] = M.beyond_nstd(f, mask, 1.0)
    out["beyond_2std"] = M.beyond_nstd(f, mask, 2.0)

    dt = t[..., 1:] - t[..., :-1]
    df = f[..., 1:] - f[..., :-1]
    pair = mask[..., 1:] & mask[..., :-1]
    valid = pair & (dt > 0)
    slopes = torch.where(valid, torch.abs(df) / torch.where(valid, dt, 1.0), -1.0)
    ms = slopes.amax(dim=-1)
    out["max_slope"] = torch.where((n > 1) & valid.any(dim=-1), ms, 0.0)

    snr_mask = mask & (e > 0)
    out["mean_snr"] = M.mean(torch.abs(f) / torch.where(e > 0, e, 1.0), snr_mask)

    span = M.mmax(t, mask) - M.mmin(t, mask)
    out["time_span"] = torch.where(n > 1, span, 0.0)
    cad = M.mean(torch.where(pair, dt, 0.0), pair)
    out["cadence_mean"] = torch.where(n > 1, cad, 0.0)

    for k in out:
        if k != "n_obs":
            out[k] = torch.where(empty, _NAN, out[k])
    return out


def _ratio(a, b):
    ok = ~torch.isnan(a) & (b > 0)
    return torch.where(ok, a / torch.where(ok, b, 1.0), _NAN)


def extract(packed, meta=None) -> FeatureSet:
    """Statistical features; appends metadata features when meta is given."""
    feats: FeatureSet = {}
    band_stats = _series_stats(packed.band_time, packed.band_flux,
                               packed.band_err, packed.band_mask)
    for bi, band in enumerate(LSST_BANDS):
        for name in STAT_NAMES:
            feats[f"{band}_{name}"] = band_stats[name][:, bi]

    all_stats = _series_stats(packed.all_time, packed.all_flux,
                              packed.all_err, packed.all_mask)
    for name in STAT_NAMES:
        feats[f"all_{name}"] = all_stats[name]

    means = band_stats["mean"]  # [N, 6] u,g,r,i,z,y
    maxes = band_stats["max"]
    feats["flux_ratio_g_r"] = _ratio(means[:, 1], means[:, 2])
    feats["flux_ratio_r_i"] = _ratio(means[:, 2], means[:, 3])
    feats["flux_ratio_i_z"] = _ratio(means[:, 3], means[:, 4])

    nan_max = torch.isnan(maxes)
    any_band = (~nan_max).any(dim=1)
    peak_band = torch.argmax(torch.where(nan_max, -torch.inf, maxes), dim=1)
    feats["peak_band"] = torch.where(any_band, peak_band, -1).to(torch.float32)

    feats = sorted_features(feats)
    if meta is not None:
        z = per_object(meta.z, packed)
        feats["Z"] = z
        feats["EBV"] = per_object(meta.ebv, packed)
        feats["luminosity_distance"] = z * 4280.0
        feats["time_dilation"] = 1.0 + z
    return feats
